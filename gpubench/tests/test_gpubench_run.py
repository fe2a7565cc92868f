"""The run's guards: no JAX and no JAX package in a run (the top-level
module name compared whole: the port's name begins with the JAX
package's), a reference that imports nothing of the program, no result
without a card, and a result line that keeps to the contract."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sbr_rs_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (FORBIDDEN | {"sbr_rs_tpu_torch"}), (path, tops)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops)


def test_a_run_at_a_toy_size_loads_no_jax_module():
    shrink = {"cfg": {"num_items": 140_000, "embedding_dim": 7},
              "traffic": {"users_per_batch": 16, "pool_batches": 2, "check_users": 16}}
    out = subprocess.run(
        [sys.executable, str(HERE / "rehearse.py"), "--workload", "lstm32-items50m.serve-batch",
         "--seed", "2718281829", "--seconds", "0.2", "--trace", "1", "--shrink", json.dumps(shrink)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden_modules"] == []
    assert line["correct"] is True
    assert "rechecked_share.serve_batch" in line["metrics"]


def test_forbidden_modules_compare_the_top_level_name_whole(monkeypatch):
    from gpubench.cell import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sbr_rs_tpu_torch_probe.models", type(sys)("probe"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sbr_rs_tpu.models", type(sys)("probe"))
    monkeypatch.setitem(sys.modules, "jaxlib", type(sys)("probe"))
    assert forbidden_modules() == ["jaxlib", "sbr_rs_tpu"]


def test_without_a_card_the_run_prints_no_result(card_absent):
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "lstm32-items50m.serve-batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_benchmark_json_keeps_to_the_contract():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gpubench/")
    assert 0 < e2e["setup_s"]["bound"] <= 0.25
