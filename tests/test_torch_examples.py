"""The port's examples and its profiler trace, on the CPU.

``examples/torch_quickstart.py`` runs in-process at one epoch on 60
synthetic users (its ``--synthetic-users`` flag), saves, loads and serves from
the copy; ``examples/torch_lstm_hyperopt.py`` runs one trial on 30 users;
both run on the card unless asked for the CPU, and ``--dataset movielens``
reads ML-100K or raises (the download is replaced here, so nothing touches
the network). ``utils.metrics.trace`` writes a trace that names an operator
the region ran.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from sbr_rs_tpu_torch import datasets
from sbr_rs_tpu_torch.errors import DatasetError
from sbr_rs_tpu_torch.models import lstm
from sbr_rs_tpu_torch.utils.metrics import trace

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    _example("torch_quickstart").main(
        ["--device", "cpu", "--epochs", "1", "--synthetic-users", "60", "--checkpoint", str(tmp_path / "model")]
    )
    out = capsys.readouterr().out
    assert "Loaded 6360 interactions (synthetic): 60 users x 1682 items" in out
    assert "Test MRR:" in out and "item " in out
    assert "the copy serves the same top-10" in out
    assert (tmp_path / "model" / "config.json").exists() and (tmp_path / "model" / "state.msgpack").exists()


def test_hyperopt_runs_one_trial(tmp_path):
    out = tmp_path / "results.json"
    _example("torch_lstm_hyperopt").main(
        ["--device", "cpu", "--trials", "1", "--seed", "0", "--synthetic-users", "30", "--out", str(out)]
    )
    results = json.loads(out.read_text())
    assert len(results) == 1
    assert results[0]["device"] == "cpu" and results[0]["hyperparameters"]["model_type"] == "lstm"
    assert 0 < results[0]["test_mrr"] <= 1 and 0 < results[0]["train_mrr"] <= 1


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_lstm_hyperopt"])
def test_examples_take_the_card_and_never_fall_back(name, monkeypatch, tmp_path):
    module = _example(name)
    args = ["--synthetic-users", "30", "--trials", "1", "--out", str(tmp_path / "r.json")]
    if name == "torch_quickstart":
        args = ["--synthetic-users", "30", "--epochs", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card is the default device
        module.main(args)

    def no_download(path=None):
        raise DatasetError("no local copy of ML-100K")

    monkeypatch.setattr(datasets, "download_movielens_100k", no_download)
    with pytest.raises(DatasetError):  # no silent switch to synthetic data
        module.main(args + ["--dataset", "movielens", "--device", "cpu"])


def test_trace_names_an_op_that_ran(tmp_path):
    model = lstm.Hyperparameters(300, 4).embedding_dim(8).from_seed(0).build("cpu")
    with trace(str(tmp_path)):
        model.recommend_batch([[1, 2, 3], [4]], k=5)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::topk" in names
