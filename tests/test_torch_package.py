"""Package-level properties of the port (``sbr_rs_tpu_torch``), on the CPU:
it never imports jax, its kernel wrappers take the plain versions for CPU
tensors only (launch counters stay 0, also through ``fit`` and evaluation),
it never falls back from CUDA, large catalogs take the sparse table update
without being asked, and its hyperparameters and parameters round-trip with
the JAX package's."""

import os
import re
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu_torch import datasets, evaluation
from sbr_rs_tpu_torch.models import Loss, Optimizer, engine, lstm
from sbr_rs_tpu_torch.ops import _build, lstm_kernels, row_kernels, topk_kernels
from sbr_rs_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys, sbr_rs_tpu_torch, sbr_rs_tpu_torch.data, sbr_rs_tpu_torch.datasets, "
        "sbr_rs_tpu_torch.models.engine, sbr_rs_tpu_torch.evaluation, sbr_rs_tpu_torch.ops.row_kernels, "
        "sbr_rs_tpu_torch.models.attention, sbr_rs_tpu_torch.models.ewma, sbr_rs_tpu_torch.models.gru, "
        "sbr_rs_tpu_torch.models.towers, sbr_rs_tpu_torch.utils.tree, sbr_rs_tpu_torch.utils.checkpoint, "
        "sbr_rs_tpu_torch.utils.msgpack_codec, sbr_rs_tpu_torch.utils.metrics, sbr_rs_tpu_torch.parallel; "
        "bad = [m for m in ('jax', 'flax', 'msgpack', 'ml_dtypes', 'sbr_rs_tpu') if m in sys.modules]; "
        "assert not bad, bad; "
        "assert {'UserId', 'ItemId', 'Timestamp', '__version__'} <= set(sbr_rs_tpu_torch.__all__); "
        "assert sbr_rs_tpu_torch.UserId is sbr_rs_tpu_torch.ItemId is sbr_rs_tpu_torch.Timestamp is int; "
        "assert sbr_rs_tpu_torch.__version__ == '0.1.0'"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|msgpack|sbr_rs_tpu)\b", re.MULTILINE)
    files = sorted((ROOT / "sbr_rs_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_multiprocess_fit.py",
    ]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


@pytest.fixture
def zero_counters():
    wrappers = (
        lstm_kernels.lstm_fwd,
        lstm_kernels.lstm_bwd,
        lstm_kernels.lstm_bwd_dwh,
        topk_kernels.score_groupmax,
        topk_kernels.score_submax_groupmax,
        topk_kernels.score_count_ge,
        row_kernels.gather_rows,
        row_kernels.scatter_add_rows_,
        row_kernels.cand_score_smem,
        row_kernels.cand_score_rows,
    )
    for fn in wrappers:
        fn.launches = 0
    yield wrappers
    for fn in wrappers:
        fn.launches = 0


def test_cpu_tensors_take_the_plain_versions(zero_counters):
    rng = np.random.default_rng(0)
    xz = torch.from_numpy(rng.normal(size=(5, 3, 4 * 8)).astype(np.float32))
    w_h = torch.from_numpy(rng.normal(size=(8, 4 * 8)).astype(np.float32))
    keep = torch.ones((5, 3, 1))
    for got, want in zip(lstm_kernels.lstm_fwd(xz, w_h, keep, False),
                         lstm_kernels.lstm_fwd_plain(xz, w_h, keep, False)):
        assert torch.equal(got, want)
    rows = torch.from_numpy(rng.normal(size=(3000, 9)).astype(np.float32))
    reps = torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32))
    got = topk_kernels.score_groupmax(rows, reps, 0, 2500, 32)
    assert torch.equal(got[: 3000 // 32 + 1], topk_kernels.score_groupmax_plain(rows, reps, 0, 2500, 32))
    assert torch.isneginf(got[3000 // 32 + 1 :]).all()
    smax, gmax = topk_kernels.score_submax_groupmax(rows, reps, 0, 2500, 32, 128)
    assert smax.shape == (2048 * 2 // 32, 5) and gmax.shape == (2048 * 2 // 128, 5)
    hidden, cell = lstm_kernels.lstm_fwd(xz, w_h, keep, False)
    g = torch.from_numpy(rng.normal(size=(5, 3, 8)).astype(np.float32))
    for got, want in zip(lstm_kernels.lstm_bwd(xz, w_h, hidden, cell, g, keep, False),
                         lstm_kernels.lstm_bwd_plain(xz, w_h, hidden, cell, g, keep, False)):
        assert torch.equal(got, want)
    dxz = lstm_kernels.lstm_bwd_plain(xz, w_h, hidden, cell, g, keep, False)[0]
    assert torch.equal(lstm_kernels.lstm_bwd_dwh(hidden, keep, dxz),
                       lstm_kernels.lstm_bwd_dwh_plain(hidden, keep, dxz))
    table = torch.from_numpy(rng.normal(size=(50, 9)).astype(np.float32))
    idx = torch.tensor([3, 50, 7, 50])
    assert torch.equal(row_kernels.gather_rows(table, idx), row_kernels.gather_rows_plain(table, idx))
    delta = torch.ones((4, 9))
    want = row_kernels.scatter_add_rows_plain(table.clone(), idx, delta)
    assert torch.equal(row_kernels.scatter_add_rows_(table, idx, delta), want)
    haug = torch.from_numpy(rng.normal(size=(6, 9)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(0, 50, (6, 5)))
    for fn in (row_kernels.cand_score, row_kernels.cand_score_smem, row_kernels.cand_score_rows):
        assert torch.equal(fn(haug, table, cand), row_kernels.cand_score_plain(haug, table, cand))
    for sparse in (False, True):
        model = (lstm.Hyperparameters(300, 4).embedding_dim(8).loss(Loss.WARP)
                 .sparse_updates(sparse).from_seed(0).build("cpu"))
        assert len(model.recommend_batch([[1, 2], []], k=3)) == 2
        data = datasets.synthetic_interactions(20, 300, 8, rng=0).to_compressed()
        model.fit(data)
        assert np.isfinite(evaluation.mrr_score(model, data))
    assert all(fn.launches == 0 for fn in zero_counters)


def test_no_fallback_from_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lstm.Hyperparameters(100, 4).embedding_dim(8).build(torch.device("cuda"))
    with pytest.raises(RuntimeError):  # the card is the default device
        lstm.Hyperparameters(100, 4).embedding_dim(8).build()
    with pytest.raises(ValueError):
        lstm.Hyperparameters(100, 4).embedding_dim(8).build(torch.device("meta"))
    meta = torch.empty((4096, 9), device="meta")
    with pytest.raises(ValueError):
        topk_kernels.score_groupmax(meta, torch.empty((2, 9), device="meta"), 0, 4096, 32)
    with pytest.raises(ValueError):
        lstm_kernels.lstm_fwd(torch.empty((2, 3, 32), device="meta"), torch.empty((8, 32)),
                              torch.empty((2, 3, 1)), False)
    seq = torch.empty((2, 3, 8), device="meta")
    with pytest.raises(ValueError):
        lstm_kernels.lstm_bwd(torch.empty((2, 3, 32), device="meta"), torch.empty((8, 32)),
                              seq, seq, seq, torch.empty((2, 3, 1)), False)
    with pytest.raises(ValueError):
        lstm_kernels.lstm_bwd_dwh(seq, torch.empty((2, 3, 1)), torch.empty((2, 3, 32)))
    rows = torch.empty((10, 9), device="meta")
    ids = torch.zeros((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        row_kernels.gather_rows(rows, ids)
    with pytest.raises(ValueError):
        row_kernels.scatter_add_rows_(rows, ids, torch.empty((4, 9), device="meta"))
    for fn in (row_kernels.cand_score, row_kernels.cand_score_rows, row_kernels.cand_score_smem):
        with pytest.raises(ValueError):
            fn(torch.empty((4, 9), device="meta"), rows, torch.zeros((4, 5), dtype=torch.int64, device="meta"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    with pytest.raises(_build.KernelCompileError):
        _build.find_nvcc()


def test_sparse_updates_auto_switch_builds_the_sparse_step():
    cfg = engine.EngineConfig(
        num_items=10, loss=Loss.BPR, optimizer=Optimizer.ADAM, learning_rate=0.1, l2_penalty=0.0
    )
    assert cfg.sparse_updates is True  # the JAX package's default
    assert callable(engine.make_train_step(cfg, lambda p, x, starts=None: x))
    big = (lstm.Hyperparameters(300_000, 4).embedding_dim(16).learning_rate(0.1).num_epochs(2)
           .from_seed(0).build("cpu"))
    assert big._engine_config().sparse_updates  # N * D > 2**22: the sparse path
    assert not lstm.Hyperparameters(3706, 4).embedding_dim(128).build("cpu")._engine_config().sparse_updates
    # The large model fits with no argument beyond the JAX package's, and
    # only touched rows move: the data's items and the drawn negatives.
    table = big._params["item_table"].clone()
    data = datasets.synthetic_interactions(20, 300_000, 8, rng=0).to_compressed()
    assert np.isfinite(big.fit(data))
    moved = set(torch.nonzero((big._params["item_table"] != table).any(dim=1))[:, 0].tolist())
    assert set(data.item_ids.tolist()) <= moved
    assert len(moved) <= 2 * len(data) * big.hyper._num_epochs


def test_hyperparameters_round_trip_with_jax():
    jd = (
        jax_lstm.Hyperparameters(1234, 16)
        .embedding_dim(24)
        .lstm_variant(jax_lstm.LSTMVariant.NORMAL)
        .table_dtype("bfloat16")
        .lr_schedule("cosine")
        .from_seed(7)
        .to_dict()
    )
    hp = lstm.Hyperparameters.from_dict(jd)
    assert hp._lstm_variant is lstm.LSTMVariant.NORMAL
    d = hp.to_dict()
    assert d == jd
    assert jax_lstm.Hyperparameters.from_dict(d).to_dict() == jd


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_params_round_trip(dtype):
    rng = np.random.default_rng(1)
    tree = {
        "item_table": rng.normal(size=(50, 9)).astype(dtype),
        "tower": {
            "w_x": rng.normal(size=(8, 24)).astype(np.float32),
            "w_h": rng.normal(size=(8, 24)).astype(np.float32),
            "b": rng.normal(size=(24,)).astype(np.float32),
        },
    }
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert back["item_table"].dtype == tree["item_table"].dtype
    np.testing.assert_array_equal(back["item_table"], tree["item_table"])
    for name, v in tree["tower"].items():
        np.testing.assert_array_equal(back["tower"][name], v)


def test_load_numpy_params_and_clone():
    model = lstm.Hyperparameters(50, 4).embedding_dim(8).from_seed(3).build("cpu")
    tree = params_to_numpy(model)
    tree["item_table"] = tree["item_table"] + 1.0
    model.load_numpy_params(tree)
    np.testing.assert_array_equal(model.item_biases, tree["item_table"][:, -1])
    twin = model.clone()
    hs = [[1, 2, 3], [4]]
    assert twin.recommend_batch(hs, k=5) == model.recommend_batch(hs, k=5)
    twin._params["item_table"].zero_()
    assert model.item_embeddings.any()
    tree["tower"]["w_h"] = tree["tower"]["w_h"][:, :-1]
    with pytest.raises(ValueError):
        model.load_numpy_params(tree)


def test_source_digest_covers_headers(tmp_path):
    """The built library is named by a digest of the kernel sources and the
    headers they include: editing a ``.cuh`` must rebuild, and an unchanged
    tree must load the library it built before."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (csrc / src.name).write_bytes(src.read_bytes())
    assert (csrc / "tf32x3.cuh").exists()
    first = _build.source_digest(csrc)
    assert _build.source_digest(csrc) == first
    assert _build.source_digest(_build.CSRC) == first  # names and contents only
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.source_digest(csrc)
    assert edited != first
    (csrc / "score_count.cu").write_text((csrc / "score_count.cu").read_text() + "\n")
    assert _build.source_digest(csrc) not in (first, edited)
