"""A later PR adds a configuration, a cell, a per-layer metric, a model
family, a counter or a kernel map as new files and new entries of
``BENCHMARK.json``; the harness finds them by name and no file of the
benchmark changes. A name in two files, or a family without its files,
raises."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import flops, program, spec, weights
from gpubench.reference import towers

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


# A family the harness lacks: the port's EWMA (sbr-rs ``src/models/ewma.rs``),
# its program side, its plain tower, a counter and a kernel map of its own.
EWMA_FAMILY = """
def hyperparameters(cfg):
    from sbr_rs_tpu_torch.models import ewma

    return ewma.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"])


def tower_shapes(cfg):
    return [("alpha", (int(cfg["embedding_dim"]),), "b", None)]


def tower_flops(cfg, positions, keys):
    return positions * 3.0 * int(cfg["embedding_dim"])
"""
EWMA_REFERENCE = """
import torch


def apply(cfg, p, x):
    a = torch.sigmoid(p["alpha"])
    u = x[:, 0]
    out = [u]
    for t in range(1, x.shape[1]):
        u = a * u + (1 - a) * x[:, t]
        out.append(u)
    return torch.stack(out, dim=1)
"""


def test_a_new_family_is_new_files_only(tmp_path):
    bench_dir = tmp_path / "gpubench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench_dir)

    cfg = json.loads((HERE / "configs" / "lstm32-items50m.json").read_text())
    del cfg["lstm_variant"]
    cfg.update(name="ewma15-items140k", family="ewma", num_items=140_000, embedding_dim=15)
    added = {
        "families/ewma.py": EWMA_FAMILY,
        "reference/ewma.py": EWMA_REFERENCE,
        "counters/ewma.json": json.dumps(
            {"ewma_k4_launches": ["sbr_rs_tpu_torch.ops.topk_kernels", "score_submax_groupmax", "launches"]}),
        "kernels/ewma.json": json.dumps({"ewma_scan_kernel": ["ewma_k4_launches"]}),
        "metrics/ewma_k4_launches.py": "def read(r, name):\n    return r['counters'].get('ewma_k4_launches')\n",
        "configs/ewma15-items140k.json": json.dumps(cfg),
    }
    work = json.loads((HERE / "workloads" / "lstm32-items50m.serve-batch.json").read_text())
    work.update(config="ewma15-items140k")
    work["traffic"].update(users_per_batch=16, pool_batches=2, check_users=16)
    added["workloads/ewma15-items140k.serve-batch.json"] = json.dumps(work)
    for rel, text in added.items():
        (bench_dir / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ewma15-items140k", "source": "https://github.com/maciejkula/sbr-rs",
                             "file": "gpubench/configs/ewma15-items140k.json", "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "ewma15-items140k.serve-batch", "config": "ewma15-items140k",
                               "traffic": "serve-batch", "chips": 1, "why": "a toy"})
    bench["end_to_end"][0]["workloads"].append("ewma15-items140k.serve-batch")
    bench["per_layer"].append({"name": "ewma_k4_launches", "unit": "launches", "better": "lower",
                               "source": "program_counter", "layer": "ops/topk_kernels.py K4",
                               "moves": "serve_users_per_s", "workloads": ["ewma15-items140k.serve-batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    lines = {}
    for trace in (0, 1):
        out = subprocess.run(
            [sys.executable, str(bench_dir / "rehearse.py"), "--workload", "ewma15-items140k.serve-batch",
             "--seed", "2718281829", "--seconds", "0.2", "--trace", str(trace)],
            capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
        )
        assert out.returncode == 0, out.stderr[-3000:]
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
        assert lines[trace]["correct"] is True, lines[trace]["checks"]
        assert lines[trace]["forbidden_modules"] == []
    assert set(lines[0]["metrics"]) == {"serve_users_per_s", "setup_s"}
    assert lines[1]["metrics"]["ewma_k4_launches"]["value"] == 0  # the CPU runs no kernel
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {Path(rel) for rel in added}


@pytest.mark.parametrize("folder,text", [
    ("counters", {"rechecked_users": ["sbr_rs_tpu_torch.models.base", "topk_streamed", "rechecked_users"]}),
    ("kernels", {"score_submax_kernel": ["score_submax_groupmax"]}),
])
def test_a_name_in_two_files_raises(tmp_path, folder, text):
    shutil.copytree(HERE / folder, tmp_path / folder)
    (tmp_path / folder / "again.json").write_text(json.dumps(text))
    with pytest.raises(ValueError, match=f"{next(iter(text))!r} is in both"):
        spec.merged(folder, tmp_path)


W = {"embedding_std": 0.25, "bias_std": 0.05, "tower_bias_std": 0.1}
NO_FAMILY = {"family": "hstu", "num_items": 300, "embedding_dim": 8, "max_sequence_length": 6}


@pytest.mark.parametrize("where,call", [
    ("families", lambda: program.build(NO_FAMILY, 5, W, "cpu")),
    ("families", lambda: weights.tower_leaves(5, NO_FAMILY, W, "cpu")),
    ("families", lambda: flops.serve_batch(NO_FAMILY, [3, 4], 300)),
    ("reference", lambda: towers.representations(NO_FAMILY, {"x": None}, None, [[1, 2]])),
])
def test_a_family_without_its_file_raises(where, call):
    with pytest.raises(KeyError, match=f"{where}/hstu.py"):
        call()
