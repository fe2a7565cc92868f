"""The pipelined small route (``models/base.py``
``ImplicitSequenceModel.recommend_batch`` in
``ImplicitSequenceModel._pipeline_parts`` sub-batches) and the seen filter
of ``topk_small``, on the CPU.

With ``PIPELINE_MIN_USERS`` monkeypatched to 3, a batch of 11 users runs as
3 sub-batches of 3, 4 and 4 users: the first holds an empty history, the
seen widths of the three differ, and one history is longer than the
window. Each pipelined call returns the ids of the one-sub-batch call on
the same model, and scores within 1e-7 (a user's representation does not
depend on its batch, to that tolerance: ``test_torch_hstu.py``). The
counter ``recommend_batch.pipelined_subbatches`` moves only on the small
route with at least ``2 * PIPELINE_MIN_USERS`` users. ``topk_small``'s
scatter is held bit for bit to the boolean-mask filter it replaced, which
is kept here as the reference.

On a card only (skipped here): the pipelined call's lists against the
one-batch call's and the CPU's, its host waits under the profiler, and a
call that raises in its last sub-batch followed by one that serves.
This file imports no JAX, so that on a card it runs alone:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_pipeline.py -m card``.
"""

import collections
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sbr_rs_tpu_torch.models import base, hstu, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.utils import metrics

NUM_ITEMS, DIM, SEQ_LEN, K = 64, 8, 12, 5
MIN_USERS = 3
# 11 users: sub-batches [0, 3), [3, 7), [7, 11) at PIPELINE_MIN_USERS = 3.
LENGTHS = [2, 0, 1, 30, 5, 7, 1, 2, 1, 15, 3]
PARTS = len(LENGTHS) // MIN_USERS
PREFIX = metrics.SPAN_PREFIX


def _model(family, num_items=NUM_ITEMS):
    if family == "lstm":
        return lstm.Hyperparameters(num_items, SEQ_LEN).embedding_dim(DIM).from_seed(1).build("cpu")
    return (hstu.Hyperparameters(num_items, SEQ_LEN).embedding_dim(DIM).num_layers(2).num_heads(2)
            .from_seed(3).build("cpu"))


def _batch(family, lengths=LENGTHS, arrays=False, seed=0, num_items=NUM_ITEMS):
    """Histories of ``lengths`` (lists of ints, or int64 arrays as an
    offline job sends them) and, for HSTU, nondecreasing times."""
    rng = np.random.default_rng(seed)
    hist = [rng.integers(0, num_items, n) for n in lengths]
    times = [10**9 + np.cumsum(rng.integers(1, 10**6, n)) for n in lengths]
    if not arrays:
        hist, times = [h.tolist() for h in hist], [t.tolist() for t in times]
    return hist, (times if family == "hstu" else None)


def _serve(model, hist, times, min_users, monkeypatch, **kw):
    monkeypatch.setattr(base, "PIPELINE_MIN_USERS", min_users)
    return model.recommend_batch(hist, k=K, timestamps=times, **kw)


def _subbatches():
    return ImplicitSequenceModel.recommend_batch.pipelined_subbatches


@pytest.mark.parametrize("arrays", [False, True], ids=["lists", "arrays"])
@pytest.mark.parametrize("return_scores", [True, False])
@pytest.mark.parametrize("exclude_seen", [True, False])
@pytest.mark.parametrize("family", ["lstm", "hstu"])
def test_a_pipelined_call_serves_the_one_batch_lists(family, exclude_seen, return_scores, arrays, monkeypatch):
    model = _model(family)
    hist, times = _batch(family, arrays=arrays)
    kw = dict(exclude_seen=exclude_seen, return_scores=return_scores)
    before = _subbatches()
    want = _serve(model, hist, times, 10**9, monkeypatch, **kw)
    assert _subbatches() == before
    got = _serve(model, hist, times, MIN_USERS, monkeypatch, **kw)
    assert _subbatches() == before + PARTS
    if return_scores:
        (want, want_s), (got, got_s) = want, got
        assert got_s.dtype == want_s.dtype and got_s.shape == want_s.shape == (len(LENGTHS), K)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-7)
    assert got == want
    if exclude_seen:
        assert all(not set(row) & set(np.asarray(h).tolist()) for row, h in zip(got, hist))


@pytest.mark.parametrize(
    "case, users, num_items, constants, width",
    [
        ("small", 11, NUM_ITEMS, {}, 30),
        ("under_twice_the_minimum", 2 * MIN_USERS - 1, NUM_ITEMS, {}, 30),
        ("streamed", 11, 5000, {"_SERVE_ITEM_CHUNK": 2048}, 30),
        ("wide_seen", 11, 5000, {"_SERVE_ITEM_CHUNK": 2048, "_SERVE_MAX_POSTFILTER_SEEN": 8}, 30),
    ],
)
def test_the_counter_moves_on_the_small_route_alone(case, users, num_items, constants, width, monkeypatch):
    """``users`` histories of lengths up to ``width``; the streamed and
    wide-seen routes (a catalog past the chunk) and a batch under twice the
    minimum keep one sub-batch, and their lists are the same either way."""
    for name, value in constants.items():
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    model = _model("lstm", num_items)
    lengths = [width] + [1 + i % 7 for i in range(users - 1)]
    hist, _ = _batch("lstm", lengths, num_items=num_items, seed=4)
    want = _serve(model, hist, None, 10**9, monkeypatch, return_scores=True)
    before = _subbatches()
    got = _serve(model, hist, None, MIN_USERS, monkeypatch, return_scores=True)
    expected = users // MIN_USERS if case == "small" else 0
    assert _subbatches() - before == expected
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-7)


def test_a_table_split_over_model_keeps_one_sub_batch(monkeypatch):
    monkeypatch.setattr(base, "PIPELINE_MIN_USERS", MIN_USERS)
    model = _model("lstm")
    assert model._pipeline_parts(11) == PARTS
    assert model._pipeline_parts(2 * MIN_USERS - 1) == 1
    monkeypatch.setattr(model.hyper, "_mesh", types.SimpleNamespace(model=2, data=1))
    assert model._pipeline_parts(11) == 1
    monkeypatch.setattr(model.hyper, "_mesh", types.SimpleNamespace(model=1, data=2))
    assert model._pipeline_parts(11) == PARTS


@pytest.mark.parametrize("family", ["lstm", "hstu"])
def test_an_id_outside_the_catalog_in_the_last_sub_batch_raises(family, monkeypatch):
    """It raises, and the next call on the same model serves the lists."""
    model = _model(family)
    hist, times = _batch(family)
    want = _serve(model, hist, times, MIN_USERS, monkeypatch)
    bad = hist[:-1] + [hist[-1][:-1] + [NUM_ITEMS]]  # the last history's last item: inside its window
    with pytest.raises(base.InvalidPredictionValue):
        _serve(model, bad, times, MIN_USERS, monkeypatch)
    assert _serve(model, hist, times, MIN_USERS, monkeypatch) == want


def test_timestamps_are_checked_across_sub_batches(monkeypatch):
    model = _model("hstu")
    hist, times = _batch("hstu")
    bad = times[:-1] + [times[-1][:-1]]
    with pytest.raises(ValueError, match=f"history {len(LENGTHS) - 1} has 3 items but 2 timestamps"):
        _serve(model, hist, bad, MIN_USERS, monkeypatch)
    with pytest.raises(ValueError, match=f"{len(LENGTHS) - 1} rows of timestamps for {len(LENGTHS)} histories"):
        _serve(model, hist, times[:-1], MIN_USERS, monkeypatch)


def _spans(prof):
    """``(name, parent)`` of every ``sbr.`` span, the parent the innermost
    ``sbr.`` span around it (``None`` for a root)."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(PREFIX):], None if p is None else p.name[len(PREFIX):]))
    return out


@pytest.mark.parametrize("family", ["lstm", "hstu"])
def test_each_sub_batch_records_its_spans_under_one_call(family, monkeypatch):
    """By the counting of ``test_a_call_sorts_its_seen_rows_while_the_tower_runs``:
    each sub-batch records ``serve.prepare`` twice and every other stage's
    span once, the call ``serve.budgets`` once, all inside the one
    ``sbr.recommend_batch``, and the call serves the same bits as with no
    profiler."""
    model = _model(family)
    hist, times = _batch(family, arrays=True)
    want = _serve(model, hist, times, MIN_USERS, monkeypatch, return_scores=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _serve(model, hist, times, MIN_USERS, monkeypatch, return_scores=True)
    assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
    expected = {
        ("recommend_batch", None): 1,
        ("serve.prepare", "recommend_batch"): 2 * PARTS,
        ("serve.budgets", "recommend_batch"): 1,
        ("serve.tower", "recommend_batch"): PARTS,
        ("tower.inputs", "serve.tower"): PARTS,
        ("serve.topk", "recommend_batch"): PARTS,
        ("topk.small", "serve.topk"): PARTS,
        ("serve.to_host", "recommend_batch"): PARTS,
    }
    if family == "hstu":
        expected.update({("hstu.tower", "serve.tower"): PARTS, ("hstu.bias", "hstu.tower"): PARTS,
                         ("hstu.attention", "hstu.tower"): 2 * PARTS})
    assert dict(collections.Counter(_spans(prof))) == expected


def _masked_topk(table, reps, seen, k):
    """The filter ``topk_small`` had: a boolean mask of the seen slots
    inside the catalog, then one indexed write (its ``nonzero`` waits for
    the card)."""
    tab = table.to(torch.float32)
    n = tab.shape[0]
    scores = reps @ tab[:, :-1].T + tab[:, -1]
    valid = (seen >= 0) & (seen < n)
    rows = torch.arange(reps.shape[0])[:, None].expand_as(seen)
    scores[rows[valid], seen[valid]] = float("-inf")
    return torch.topk(scores, min(k, n), dim=1)


def _nonzero_inside(prof, span_name):
    """``aten::nonzero`` events whose ancestors include ``span_name``."""
    found = 0
    for e in prof.events():
        if e.name != "aten::nonzero":
            continue
        p = e.cpu_parent
        while p is not None and p.name != span_name:
            p = p.cpu_parent
        found += p is not None
    return found


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "history_order"])
@pytest.mark.parametrize("k", [4, 12])
def test_topk_small_filters_seen_items_as_the_mask_did(k, sort):
    """Rows: padding slots (n) among seen ids; ids past the catalog and
    negative ones; one empty slot (``exclude_seen=False``); repeated ids;
    a row whose seen items fill its top ``k`` (the last ``k`` slots of
    its list are ``-inf``); a row with every slot outside the catalog;
    each row sorted, as ``_slab_seen`` sorts them, or in history order,
    as ``_seen_rows`` leaves them. The ids and scores are the mask's
    bit for bit, and no ``nonzero`` runs inside ``sbr.topk.small``."""
    n, d, u = 20, 6, 7
    g = torch.Generator().manual_seed(5)
    table = torch.randn((n, d + 1), generator=g)
    reps = torch.randn((u, d), generator=g)
    full = torch.argsort(reps @ table[:, :-1].T + table[:, -1], dim=1, descending=True)[4, :16]
    seen = torch.full((u, 16), n, dtype=torch.int64)
    seen[0, :3] = torch.tensor([2, 5, 9])
    seen[1, :4] = torch.tensor([-1, 3, n + 5, 7])
    seen[2, :5] = torch.tensor([1, 1, 4, 4, n])
    seen[3] = n
    seen[4] = full  # the row's 16 best items: a top-k of <= 16 items all -inf but the rest
    seen[5, :2] = torch.tensor([n + 1, -3])
    seen[6, :2] = torch.tensor([0, n - 1])
    if sort:
        seen = seen.sort(dim=1).values
    for width in (16, 1):
        s = seen if width == 16 else torch.full((u, 1), n, dtype=torch.int64)
        want_v, want_i = _masked_topk(table, reps, s, k)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got_v, got_i = base.topk_small(table, reps, s, k)
        assert torch.equal(got_i, want_i)
        assert got_v.view(torch.int32).equal(want_v.view(torch.int32))
        assert _nonzero_inside(prof, PREFIX + "topk.small") == 0
    assert torch.isinf(got_v).sum() == 0  # one empty slot: nothing filtered
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("topk.small"):
            _masked_topk(table, reps, seen, k)
    assert _nonzero_inside(prof, PREFIX + "topk.small") > 0  # the count sees the mask's waits


@pytest.mark.parametrize(
    "rows",
    [
        [np.array([3, 1], np.int64), np.array([], np.int64), np.array([7], np.int64)],
        [np.array([3, 1], np.int32), np.array([2], np.int32)],
        [np.array([3, 1]), [], [7, 8]],
        [[3, 1], [], [7]],
        [np.array([1.0, 2.0]), np.array([3.0])],
    ],
    ids=["int64_arrays", "int32_arrays", "mixed", "lists", "float_arrays"],
)
def test_rows_written_into_a_buffer_are_the_rows(rows):
    lens = np.array([len(r) for r in rows], dtype=np.int64)
    want = base._concat_rows(rows, lens)
    out = np.full(int(lens.sum()), -1, np.int64)
    got = base._concat_rows(rows, lens, out)
    assert got is out and got.dtype == np.int64 and got.tolist() == want.tolist()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_models(card):
    """The same 8-block HSTU model (300 items, T = 24, D = 50, 2 heads) on
    the CPU and on the card, its item biases spread (no near ties)."""
    hp = hstu.Hyperparameters(300, 24).embedding_dim(50).num_layers(8).num_heads(2).from_seed(9)
    on_cpu, on_card = hp.build("cpu"), hp.build(card)
    on_cpu._params["item_table"][:, -1] = torch.randn(300, generator=torch.Generator().manual_seed(9))
    on_card.load_params(on_cpu._params)
    return on_cpu, on_card


@pytest.mark.card
def test_card_pipelined_serving_is_the_one_batch_call(card, monkeypatch):
    """On the card, through pinned buffers and copies that do not wait: the
    one-batch call's lists and scores within 1e-6, and the CPU's lists,
    scores within ``tests/test_torch_hstu.py``'s 1e-5."""
    on_cpu, on_card = _card_models(card)
    rng = np.random.default_rng(9)
    lens = [0, 1, 2, 23, 24, 25, 60, 7, 13, 30, 5, 19, 2, 40]
    hist = [rng.integers(0, 300, n) for n in lens]
    times = [np.cumsum(rng.integers(1, 10**6, n)) for n in lens]
    want = _serve(on_cpu, hist, times, 10**9, monkeypatch, return_scores=True)
    alone = _serve(on_card, hist, times, 10**9, monkeypatch, return_scores=True)
    before = _subbatches()
    got = _serve(on_card, hist, times, MIN_USERS, monkeypatch, return_scores=True)
    assert _subbatches() - before == len(lens) // MIN_USERS
    assert got[0] == alone[0] == want[0]
    np.testing.assert_allclose(got[1], alone[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.card
def test_card_a_pipelined_call_waits_once_a_sub_batch(card, monkeypatch):
    """Under the profiler, one pipelined call waits for the card by one
    event a sub-batch: no stream synchronise (a pageable copy's) and no
    ``nonzero``, in the call or inside ``sbr.serve.topk``."""
    _, on_card = _card_models(card)
    rng = np.random.default_rng(10)
    lens = rng.integers(1, 60, 12)
    hist = [rng.integers(0, 300, n) for n in lens]
    times = [np.cumsum(rng.integers(1, 10**6, n)) for n in lens]
    _serve(on_card, hist, times, MIN_USERS, monkeypatch, return_scores=True)  # warm the pinned pool
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _serve(on_card, hist, times, MIN_USERS, monkeypatch, return_scores=True)
    names = collections.Counter(e.name for e in prof.events())
    assert names["cudaEventSynchronize"] == len(lens) // MIN_USERS
    assert names["cudaStreamSynchronize"] == 0
    assert names["aten::nonzero"] == 0
    assert _nonzero_inside(prof, PREFIX + "serve.topk") == 0


@pytest.mark.card
def test_card_a_call_that_raises_leaves_the_next_one_whole(card, monkeypatch):
    """An id outside the catalog in the last sub-batch raises while the
    sub-batches before it may still be on the card; the next calls, which
    take pinned buffers from the same pool, serve the lists of a call made
    before it, bit for bit."""
    _, on_card = _card_models(card)
    rng = np.random.default_rng(11)
    lens = rng.integers(1, 60, 12)
    hist = [rng.integers(0, 300, n) for n in lens]
    times = [np.cumsum(rng.integers(1, 10**6, n)) for n in lens]
    want = _serve(on_card, hist, times, MIN_USERS, monkeypatch, return_scores=True)
    bad = hist[:-1] + [np.append(hist[-1][:-1], 300)]
    for _ in range(3):
        with pytest.raises(base.InvalidPredictionValue):
            _serve(on_card, bad, times, MIN_USERS, monkeypatch, return_scores=True)
        got = _serve(on_card, hist, times, MIN_USERS, monkeypatch, return_scores=True)
        assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
