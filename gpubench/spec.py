"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``workloads/<cell>.json``, the configuration file that
``BENCHMARK.json`` names, ``traffic/<kind>.py`` and ``metrics/<metric>.py``
(or ``metrics/<name before the first dot>.py``, which is given the whole
name). A later cell, configuration, traffic kind or metric is a new file
and a new entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_workload(name: str, here: Path = HERE) -> Dict:
    path = here / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload file {path}")
    return json.loads(path.read_text())


def load_config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    """The file ``BENCHMARK.json`` names for configuration ``name``."""
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _load(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_module(kind: str, here: Path = HERE):
    path = here / "traffic" / f"{kind}.py"
    if not path.is_file():
        raise KeyError(f"no traffic kind {path}")
    return _load(path, f"gpubench.traffic.{kind}")


def metric_module(name: str, here: Path = HERE):
    for stem in (name, name.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.is_file():
            return _load(path, f"gpubench.metrics.{stem.replace('.', '_')}")
    raise KeyError(f"no reader for metric {name!r} under {here / 'metrics'}")


def _for(entries: List[Dict], cell: str) -> List[Dict]:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def end_to_end_for(bench: Dict, cell: str) -> List[Dict]:
    return _for(bench["end_to_end"], cell)


def per_layer_for(bench: Dict, cell: str) -> List[Dict]:
    return _for(bench["per_layer"], cell)
