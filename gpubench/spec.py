"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``workloads/<cell>.json``, the configuration file that
``BENCHMARK.json`` names, ``traffic/<kind>.py``, ``metrics/<metric>.py``
(or ``metrics/<name before the first dot>.py``, which is given the whole
name), ``families/<family>.py`` and ``reference/<family>.py`` by a
configuration's ``family``, and every file of ``counters/`` and ``kernels/``,
merged. A later cell, configuration, traffic kind, metric, model family,
counter or kernel map is a new file and a new entry; no file here changes."""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
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


def family_module(family: str, here: Path = HERE):
    """The program side of a model family (``families/<family>.py``):
    ``hyperparameters(cfg)``, ``tower_shapes(cfg)``, ``tower_flops(cfg,
    positions, keys)``."""
    path = here / "families" / f"{family}.py"
    if not path.is_file():
        raise KeyError(f"no model family file {path}")
    return _load(path, f"gpubench.families.{family}")


def reference_module(family: str, here: Path = HERE):
    """The plain tower of a model family (``reference/<family>.py``):
    ``apply(cfg, p, x)`` and, optionally, ``representations(cfg, p,
    rows_fn, histories)``."""
    path = here / "reference" / f"{family}.py"
    if not path.is_file():
        raise KeyError(f"no reference file {path} for model family {family!r}")
    return _load(path, f"gpubench.reference.{family}")


def merged(folder: str, here: Path = HERE) -> Dict:
    """The JSON objects of ``<folder>/*.json`` merged into one; a key in two
    files raises."""
    out, where = {}, {}
    for path in sorted((here / folder).glob("*.json")):
        for key, value in json.loads(path.read_text()).items():
            if key in out:
                raise ValueError(f"{key!r} is in both {where[key]} and {path}")
            out[key], where[key] = value, path
    return out


def counters(here: Path = HERE) -> Dict[str, List[str]]:
    """The program's counters, ``name -> [module, function, attribute]``
    (``counters/*.json``)."""
    return merged("counters", here)


def kernel_map(here: Path = HERE) -> Dict[str, List[str]]:
    """Kernel symbols and the counters of their launches, ``symbol regex
    -> [counter names]`` (``kernels/*.json``)."""
    return merged("kernels", here)


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
