"""The sharded top-k's two steps in one process, against the whole-table
route on the CPU.

A row-sharded ``recommend_batch`` takes each slab's exact top-k as a
catalog of its own (``base.topk_slab``), then merges the slabs' lists
(``base.merge_topk_parts``); ``models/base.py`` runs the merge on every
rank after one all-gather, ``tests/test_torch_parallel.py`` in gloo ranks.
Here the slabs of one port model's table (1-4 of them, ``slab_range``'s
split, ragged where the rows do not divide) go through both steps with
the model's budgets, and the result is held against the model's own
``recommend_batch`` on the whole table, on every route: the dense top-k,
the single pass with subgroup refinement, the group-only single pass, the
running merge and the wide-seen route, each asserted taken on each slab.
Scores agree to 1e-5 relative; ids agree except where two candidates'
scores tie within that tolerance.
"""

import functools

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch.models import base, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel, _flatten, _seen_rows, merge_topk_parts, topk_slab
from sbr_rs_tpu_torch.parallel.sharding import slab_range

RTOL = 1e-5
SEQ_LEN = 8
DIM = 16
K = 6


class At:
    """Rank ``m``'s coordinates on a ``(1, model)`` mesh (what
    ``slab_range`` reads)."""

    def __init__(self, m, model):
        self.data, self.model, self.d, self.m = 1, model, 0, m


def _model(num_items, seed=0):
    model = (
        lstm.Hyperparameters(num_items, SEQ_LEN).embedding_dim(DIM)
        .lstm_variant(lstm.LSTMVariant.NORMAL).from_seed(seed).build("cpu")
    )
    rng = np.random.default_rng(seed)
    table = model._params["item_table"]
    table[:, -1] = torch.from_numpy(rng.normal(size=num_items).astype(np.float32) * 0.1)
    return model


def _histories(num_items, rng, wide=False):
    hs = [[], [1, 2, 3], list(range(20)), [num_items - 1]]
    hs += [rng.integers(0, num_items, rng.integers(2, 12)).tolist() for _ in range(5)]
    if wide:
        hs += [rng.integers(0, num_items, 40).tolist()]
    return hs


def _sharded(model, histories, k, slabs, exclude_seen=True):
    """Both steps of the sharded top-k over ``slabs`` slabs of the model's
    table: what every rank of a ``(d, slabs)`` mesh returns."""
    n = model.hyper._num_items
    flat, lens = _flatten(histories)
    reps = model._representations(flat, lens)
    width = max(int(lens.max()), 1) if exclude_seen else 1
    seen = _seen_rows(flat, lens, n, width) if exclude_seen else np.full((len(lens), 1), n, np.int64)
    seen = torch.from_numpy(seen)
    table = model._params["item_table"]
    route = functools.partial(model._catalog_topk, budgets=model._serving_budgets(len(histories), width))
    parts = []
    for m in range(slabs):
        lo, hi = slab_range(At(m, slabs), n)
        parts.append(topk_slab(route, table[lo:hi], reps, seen, k, lo, n))
    return merge_topk_parts(parts, k, n)


def _assert_topk_equal(got, want):
    (gv, gi), (wi, wv) = got, want
    gv, gi, wi = gv.numpy(), gi.numpy(), np.asarray(wi)
    assert gi.shape == wi.shape and gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0)
    with np.errstate(invalid="ignore"):  # -inf - -inf: a tie
        gaps = np.abs(np.diff(wv, axis=1)) <= RTOL * np.abs(wv[:, 1:])
    gaps |= np.isneginf(wv[:, 1:])
    tied = np.zeros(wv.shape, bool)
    tied[:, :-1] |= gaps
    tied[:, 1:] |= gaps
    np.testing.assert_array_equal(gi[~tied], wi[~tied])
    for row in gi:
        assert len(set(row.tolist())) == len(row)


# name: (constants patched on the class, the phase-1 kernel each slab
# calls (or the route function), calls a slab)
ROUTES = {
    "dense_small": ({}, "topk_small", None),
    "single_pass_submax": ({"_SERVE_ITEM_CHUNK": 64}, "score_submax_groupmax", 1),
    "group_only_pass": ({"_SERVE_ITEM_CHUNK": 64, "_SUBMAX_BUFFER_BYTES": 0}, "score_groupmax", 1),
    "running_merge": ({"_SERVE_ITEM_CHUNK": 64, "_MERGE_BUFFER_BYTES": 0}, "score_groupmax", "chunks"),
    "wide_seen": ({"_SERVE_ITEM_CHUNK": 64, "_SERVE_MAX_POSTFILTER_SEEN": 8}, "topk_small", "chunks"),
}


@pytest.mark.parametrize("slabs", [1, 2, 3, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_topk_matches_the_whole_table(route, slabs, monkeypatch):
    """400 items (3 slabs: 134, 134, 132 rows), seen lists of 0-40 items,
    a user who has seen every item of slab 0."""
    patch, fn_name, calls = ROUTES[route]
    for name, value in patch.items():
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    n = 400
    model = _model(n, seed=1)
    hs = _histories(n, np.random.default_rng(2), wide=route == "wide_seen")
    lo, hi = slab_range(At(0, slabs), n)
    hs.append(list(range(lo, min(hi, lo + 100))))  # slab 0 whole (at most 100 ids: seen width <= 128)
    want = model.recommend_batch(hs, k=K, return_scores=True)
    count = {"n": 0}
    real = getattr(base, fn_name)

    def spy(*args, **kwargs):
        count["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(base, fn_name, spy)
    got = _sharded(model, hs, K, slabs)
    _assert_topk_equal(got, want)
    if calls is not None:
        n_locs = [hi - lo for lo, hi in (slab_range(At(m, slabs), n) for m in range(slabs))]
        per_slab = [calls if calls != "chunks" else -(-n_loc // 64) for n_loc in n_locs]
        assert count["n"] == sum(per_slab)
    else:
        assert count["n"] == slabs
    for h, row in zip(hs, got[1].tolist()):
        assert not set(row) & set(h)
    _assert_topk_equal(_sharded(model, hs, K, slabs, exclude_seen=False),
                       model.recommend_batch(hs, k=K, exclude_seen=False, return_scores=True))


@pytest.mark.parametrize("n, slabs, k", [(61, 2, 6), (61, 4, 20), (61, 2, 61), (400, 4, 120)])
def test_ragged_slabs_and_k_past_a_slab(n, slabs, k, monkeypatch):
    """Ragged splits (61 rows: 31 + 30, or 16 + 16 + 16 + 13), ``k`` past a
    slab's rows (the slab's list padded) or the whole catalog; the streamed
    route's slabs of 100 rows at k = 120."""
    if n == 400:
        monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 64)
    model = _model(n, seed=3)
    hs = _histories(n, np.random.default_rng(4)) + [list(range(16))]
    got = _sharded(model, hs, min(k, n), slabs)
    want = model.recommend_batch(hs, k=k, return_scores=True)
    _assert_topk_equal(got, want)
    assert int(got[1].max()) < n  # no padding id reaches the list


def test_padding_never_displaces_a_real_item():
    """A user who has seen all but 11 of 61 items asks for 20: the lists of
    the slabs end in seen items at -inf and in padding, and the merged list
    holds the 11 unseen items, then seen ones, never a padding id."""
    n, k = 61, 20
    model = _model(n, seed=5)
    h = list(range(50))
    vals, ids = _sharded(model, [h], k, 4)
    assert sorted(ids[0, :11].tolist()) == list(range(50, 61))
    assert torch.isfinite(vals[0, :11]).all() and torch.isneginf(vals[0, 11:]).all()
    assert int(ids.max()) < n and len(set(ids[0].tolist())) == k


def test_slab_step_maps_seen_ids_and_pads():
    """The slab step by hand: a 3-row slab at rows 5-7 of a 10-item catalog,
    k = 5, a dense route that records the slab-local seen rows it gets."""
    table = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    reps = torch.ones((2, 2))
    seen = torch.tensor([[2, 6, 10], [5, 7, 9]])
    got = {}

    def route(tab, reps_, seen_, k):
        got["seen"], got["k"] = seen_.clone(), k
        return base.topk_small(tab, reps_, seen_, k)

    vals, ids = topk_slab(route, table[5:8], reps, seen, 5, 5, 10)
    assert got["k"] == 3
    assert got["seen"].tolist() == [[1, 3, 3], [0, 2, 3]]  # local, one past the slab elsewhere, sorted
    assert ids[:, 3:].tolist() == [[5 + 10 * 4, 5 + 10 * 5]] * 2  # padding: lo + N * (1 + column)
    assert torch.isneginf(vals[:, 3:]).all()
    assert ids[0, 0].item() == 7 and torch.isneginf(vals[0, 2])  # 6 seen: last among the slab's
    assert ids[1, 0].item() == 6


def test_merge_orders_parts_and_padding():
    """Equal values: the parts' order decides, and padding comes last."""
    inf = float("-inf")
    a = (torch.tensor([[3.0, 1.0, inf]]), torch.tensor([[0, 1, 10 + 20]]))
    b = (torch.tensor([[3.0, inf, inf]]), torch.tensor([[5, 6, 7]]))
    vals, ids = merge_topk_parts([a, b], 4, 10)
    assert ids.tolist() == [[0, 5, 1, 6]]
    assert vals.tolist() == [[3.0, 3.0, 1.0, inf]]
