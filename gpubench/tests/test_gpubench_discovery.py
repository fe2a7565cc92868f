"""A later PR adds a configuration, a cell and a per-layer metric as new
files and new entries of ``BENCHMARK.json``; the harness finds them by name
and no file of the benchmark changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _digests(folder: Path):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "gpubench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench_dir)

    cfg = json.loads((HERE / "configs" / "lstm32-items50m.json").read_text())
    cfg.update(name="lstm15-items140k", num_items=140_000, embedding_dim=15)
    (bench_dir / "configs" / "lstm15-items140k.json").write_text(json.dumps(cfg))
    work = json.loads((HERE / "workloads" / "lstm32-items50m.serve-batch.json").read_text())
    work.update(config="lstm15-items140k")
    work["traffic"].update(users_per_batch=16, pool_batches=2, check_users=16)
    (bench_dir / "workloads" / "lstm15-items140k.serve-batch.json").write_text(json.dumps(work))
    (bench_dir / "metrics" / "users_per_batch.py").write_text(
        "def read(r, name):\n    return r['users'] / r['units'] if r.get('units') else None\n"
    )
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lstm15-items140k", "source": "https://github.com/maciejkula/sbr-rs",
                             "file": "gpubench/configs/lstm15-items140k.json", "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "lstm15-items140k.serve-batch", "config": "lstm15-items140k",
                               "traffic": "serve-batch", "chips": 1, "why": "a toy"})
    bench["end_to_end"][0]["workloads"].append("lstm15-items140k.serve-batch")
    bench["per_layer"].append({"name": "users_per_batch.serve", "unit": "users", "better": "higher",
                               "source": "host_clock", "layer": "the whole step", "moves": "serve_users_per_s",
                               "workloads": ["lstm15-items140k.serve-batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    lines = {}
    for trace in (0, 1):
        out = subprocess.run(
            [sys.executable, str(bench_dir / "rehearse.py"), "--workload", "lstm15-items140k.serve-batch",
             "--seed", "5", "--seconds", "0.2", "--trace", str(trace)],
            capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
        )
        assert out.returncode == 0, out.stderr[-3000:]
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(lines[0]["metrics"]) == {"serve_users_per_s", "setup_s"}
    assert lines[1]["metrics"]["users_per_batch.serve"]["value"] == 16
    assert lines[1]["correct"] is True
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        Path("configs/lstm15-items140k.json"), Path("workloads/lstm15-items140k.serve-batch.json"),
        Path("metrics/users_per_batch.py"),
    }
