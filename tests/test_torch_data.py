"""The port's data layer (jax-free copies of ``data``, ``datasets`` and
``_native``) against the JAX package's, on the same seeded interactions:
every array equal, on the native (C++) path and on the numpy path both."""

import numpy as np
import pytest

from sbr_rs_tpu import _native as jax_native
from sbr_rs_tpu import data as jax_data
from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu_torch import _native, data, datasets


def _equal(a, b):
    for name in ("num_users", "num_items"):
        assert getattr(a, name) == getattr(b, name), name
    fields = [f for f in ("user_ids", "item_ids", "timestamps", "user_pointers") if hasattr(a, f)]
    assert fields
    for name in fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def _windows_equal(a, b):
    for name in ("stream", "mask", "lengths", "starts", "inputs", "targets"):
        if hasattr(a, name):
            x, y = getattr(a, name), getattr(b, name)
            if x is None or y is None:
                assert x is None and y is None, name
            else:
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages on the C++ helper, or both on their numpy paths."""
    if request.param == "numpy":
        monkeypatch.setattr(_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        assert _native.available(), "the native helper did not build"
    return request.param


def test_synthetic_interactions_equal():
    a = datasets.synthetic_interactions(50, 300, 20, rng=3)
    b = jax_datasets.synthetic_interactions(50, 300, 20, rng=3)
    _equal(a, b)
    _equal(datasets.dummy_interactions(7, 5), jax_datasets.dummy_interactions(7, 5))


def test_splits_equal():
    raw = datasets.synthetic_interactions(60, 200, 12, rng=1)
    jraw = jax_datasets.synthetic_interactions(60, 200, 12, rng=1)
    for p, j in zip(
        data.user_based_split(raw, np.random.default_rng(42), 0.2),
        jax_data.user_based_split(jraw, np.random.default_rng(42), 0.2),
    ):
        _equal(p, j)
    for p, j in zip(data.train_test_split(raw, 5, 0.25), jax_data.train_test_split(jraw, 5, 0.25)):
        _equal(p, j)
    keys = np.arange(1000, dtype=np.uint64)
    np.testing.assert_array_equal(data.siphash24(1, 2, keys), jax_data.siphash24(1, 2, keys))


@pytest.mark.parametrize("t", [4, 9])
def test_compressed_and_windows_equal(backend, t):
    raw = datasets.synthetic_interactions(40, 100, 17, rng=2)
    raw.shuffle(np.random.default_rng(0))  # CSR order is rebuilt by the sort
    jraw = jax_data.Interactions(raw.num_users, raw.num_items, raw.user_ids, raw.item_ids, raw.timestamps)
    mat, jmat = raw.to_compressed(), jraw.to_compressed()
    assert isinstance(mat, data.CompressedInteractions)
    _equal(mat, jmat)
    padded = data.extract_padded_windows(mat, t)
    jpadded = jax_data.extract_padded_windows(jmat, t)
    _windows_equal(padded, jpadded)
    _windows_equal(data.to_streams(padded), jax_data.to_streams(jpadded))
    _windows_equal(data.pack_streams(padded, t), jax_data.pack_streams(jpadded, t))
    windows = list(data.extract_windows(mat, t))
    _windows_equal(data.pad_windows(windows, t), jax_data.pad_windows(list(jax_data.extract_windows(jmat, t)), t))


def test_npz_round_trip(tmp_path):
    raw = datasets.synthetic_interactions(20, 50, 9, rng=4)
    mat = raw.to_compressed()
    raw.save(str(tmp_path / "raw.npz"))
    mat.save(str(tmp_path / "mat.npz"))
    _equal(data.Interactions.load(str(tmp_path / "raw.npz")), raw)
    _equal(data.CompressedInteractions.load(str(tmp_path / "mat.npz")), mat)
    # Files of either package load in the other.
    _equal(jax_data.CompressedInteractions.load(str(tmp_path / "mat.npz")), mat)
    jax_data.Interactions(
        raw.num_users, raw.num_items, raw.user_ids, raw.item_ids, raw.timestamps
    ).save(str(tmp_path / "jraw.npz"))
    _equal(data.Interactions.load(str(tmp_path / "jraw.npz")), raw)


def test_csv_loader(tmp_path, backend):
    path = tmp_path / "data.csv"
    path.write_text("user_id,item_id,rating,timestamp\n0,3,5,10\n1,2,4,11\n0,1,3,9\n")
    got = datasets.download_movielens_100k(str(path))
    _equal(got, jax_datasets.download_movielens_100k(str(path)))
    assert got.num_users == 2 and got.num_items == 4
