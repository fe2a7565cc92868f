"""The port's HSTU family (``models/hstu.py``, ``models/towers.py
hstu_apply``) against the plain reference ``tests/hstu_reference.py``, on
the CPU at D = 8, 2 heads, T = 12, 3 blocks, 64 items.

Tolerance: representations within 2e-6 absolute (they are unit vectors).
The port runs the whole padded window of a batch, the reference only one
sequence's valid positions, so their float32 matmuls and norms sum in other
orders; over 3 blocks that moves a component by a few 1e-7 (1.6e-7 seen).
Dropping either relative bias moves it by 1e-2 or more at these weights.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch import evaluation
from sbr_rs_tpu_torch.data import Interactions
from sbr_rs_tpu_torch.models import base, ewma, hstu, lstm
from sbr_rs_tpu_torch.models.towers import hstu_apply, hstu_position_index, hstu_time_buckets
from sbr_rs_tpu_torch.utils.tree import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
import hstu_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUM_ITEMS, DIM, SEQ_LEN, LAYERS, HEADS = 64, 8, 12, 3, 2
CFG = {"max_sequence_length": SEQ_LEN, "num_layers": LAYERS, "num_heads": HEADS}
ATOL = 2e-6


def _model(seed=3):
    """An HSTU model whose relative biases and output bias are drawn wide
    (std 0.5 and 0.1), so that each moves the output well past the
    tolerance, and whose item biases spread by 1 (no near ties)."""
    m = hstu.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).num_layers(LAYERS).num_heads(HEADS)
    m = m.from_seed(seed).build("cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for layer in m._params["tower"]["layers"]:
        for key, std in (("pos_w", 0.5), ("ts_w", 0.5), ("b_o", 0.1)):
            layer[key] = std * torch.randn(layer[key].shape, generator=g)
    m._params["item_table"][:, -1] = torch.randn(NUM_ITEMS, generator=g)
    return m


def _histories(lengths, seed=0):
    """Histories of ``lengths`` with nondecreasing times: gaps of 1 s to
    ~3 years, so that many time buckets are used."""
    rng = np.random.default_rng(seed)
    hist = [rng.integers(0, NUM_ITEMS, n).tolist() for n in lengths]
    times = [(10**9 + np.cumsum(np.rint(np.exp(rng.uniform(0, 18.4, n))))).astype(np.int64).tolist()
             for n in lengths]
    return hist, times


def _leaves(model):
    return dict(flatten(model._params["tower"]))


def _reference(model, hist, times, leaves=None):
    table = model._params["item_table"]
    return ref.representations(CFG, leaves or _leaves(model), lambda i: table[i], hist, times)


def _port(model, hist, times):
    return torch.from_numpy(np.stack([u.user_embedding for u in model.user_representations(hist, times)]))


@pytest.mark.parametrize("length", [1, 5, SEQ_LEN, 2 * SEQ_LEN])
def test_representations_match_the_reference(length):
    m = _model()
    hist, times = _histories([length, 3, length, 2 * SEQ_LEN], seed=length)
    before = hstu_apply.positions
    got = _port(m, hist, times)
    assert hstu_apply.positions - before == len(hist) * SEQ_LEN  # padding included
    torch.testing.assert_close(got, _reference(m, hist, times), rtol=0, atol=ATOL)
    one = m.user_representation(hist[0], times[0]).user_embedding
    np.testing.assert_allclose(one, got[0].numpy(), rtol=0, atol=ATOL)


def test_recommend_batch_lists_and_scores_are_the_references():
    m = _model()
    hist, times = _histories([1, 4, 7, SEQ_LEN, 19, 30], seed=7)
    ids, vals = m.recommend_batch(hist, k=6, return_scores=True, timestamps=times)
    reps = _reference(m, hist, times)
    table = m._params["item_table"]
    scores = reps @ table[:, :-1].T + table[:, -1]
    for r, h in enumerate(hist):
        scores[r, h] = float("-inf")
    want_v, want_i = torch.topk(scores, 6, dim=1)
    assert ids == want_i.tolist()
    np.testing.assert_allclose(vals, want_v.numpy(), rtol=0, atol=1e-5)
    assert m.recommend(hist[2], k=6, timestamps=times[2]) == ids[2]


def test_array_rows_serve_as_lists_do():
    """Histories and timestamps given as 1-D integer arrays (one
    ``np.concatenate`` each) serve the lists' ids and scores; an empty
    history reads as item 0 at time 0, as the reference reads it."""
    m = _model()
    hist, times = _histories([0, 3, SEQ_LEN, 2 * SEQ_LEN + 1, 0], seed=31)
    want = m.recommend_batch(hist, k=5, return_scores=True, timestamps=times)
    arrays = [np.asarray(h, dtype=np.int32) for h in hist], [np.asarray(t, dtype=np.int64) for t in times]
    got = m.recommend_batch(arrays[0], k=5, return_scores=True, timestamps=arrays[1])
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    torch.testing.assert_close(_port(m, *arrays), _reference(m, hist, times), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lens", [[0, 1, 5, SEQ_LEN, 2 * SEQ_LEN + 3, 0], [SEQ_LEN + 1, 2], [0, 0]])
def test_windows_match_a_row_by_row_layout(lens):
    """The one device layout of the tower's inputs, ``base._tower_windows``,
    with times (HSTU) and without (the untimed towers: no times, the same
    ids and positions), against a row-by-row layout: the last ``T`` entries
    left-aligned, then 0 (ids) or the last time repeated (times), an empty
    history all 0 and read at position 0."""
    lens = np.array(lens)
    flat = np.arange(int(lens.sum()), dtype=np.int64) * 7 + 3
    ids, times, last, at = [], [], [], 0
    for n in lens.tolist():
        kept = flat[at : at + n][-SEQ_LEN:].tolist()
        at += n
        ids.append(kept + [0] * (SEQ_LEN - len(kept)))
        times.append(kept + (kept[-1:] or [0]) * (SEQ_LEN + 1 - len(kept)))
        last.append(max(len(kept) - 1, 0))
    got = base._tower_windows(flat, flat, lens, SEQ_LEN, "cpu")
    assert [g.tolist() for g in got] == [ids, times, last]
    got_ids, got_times, got_last = base._tower_windows(flat, None, lens, SEQ_LEN, "cpu")
    assert got_times is None and [got_ids.tolist(), got_last.tolist()] == [ids, last]


@pytest.mark.parametrize("family", ["lstm", "hstu"])
def test_only_the_ids_a_window_reads_are_checked(family):
    """An id outside the catalog raises where the tower reads it (the last
    ``T`` of a history) and not before; the seen filter skips it. Both
    kinds of tower: untimed and timed."""
    if family == "lstm":
        m = lstm.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).from_seed(1).build("cpu")
        serve = m.recommend_batch
    else:
        m = _model()
        def serve(hs, k):
            return m.recommend_batch(hs, k=k, timestamps=[list(range(len(h))) for h in hs])
    long = list(range(SEQ_LEN + 3))
    assert len(serve([[NUM_ITEMS + 5] + long, [3]], k=4)) == 2
    with pytest.raises(base.InvalidPredictionValue):
        serve([long + [NUM_ITEMS], [3]], k=4)


@pytest.mark.parametrize("family", ["lstm", "hstu"])
def test_a_call_sorts_its_seen_rows_while_the_tower_runs(family):
    """Every family's ``recommend_batch`` records ``serve.prepare`` twice
    (the flat rows, then the seen rows once the tower is queued) and one
    ``tower.inputs`` (nothing waits for the tower there), and serves the
    same bits as with no profiler."""
    from torch.profiler import ProfilerActivity, profile

    hist, times = _histories([3, SEQ_LEN + 2, 1])
    if family == "lstm":
        m = lstm.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).from_seed(1).build("cpu")
        times, tower = None, []
    else:
        m, tower = _model(), ["sbr.hstu.tower"]
    want = m.recommend_batch(hist, k=5, return_scores=True, timestamps=times)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = m.recommend_batch(hist, k=5, return_scores=True, timestamps=times)
    assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
    names = [e.name for e in prof.events() if e.name.startswith("sbr.")]
    top = ["sbr.serve.prepare", "sbr.serve.budgets", "sbr.serve.tower", "sbr.tower.inputs", *tower,
           "sbr.serve.topk", "sbr.serve.to_host"]
    assert {n: names.count(n) for n in top} == {n: 2 if n == "sbr.serve.prepare" else 1 for n in top}


@pytest.mark.parametrize("dropped", ["ts_w", "pos_w"])
def test_a_dropped_bias_fails_the_tolerance(dropped):
    """With one relative bias zeroed in the port, its representations leave
    the reference's by more than the tolerance: both biases are computed."""
    m = _model()
    hist, times = _histories([SEQ_LEN, 9, 2 * SEQ_LEN], seed=11)
    want = _reference(m, hist, times)
    for layer in m._params["tower"]["layers"]:
        layer[dropped] = torch.zeros_like(layer[dropped])
    gap = float((_port(m, hist, times) - want).abs().max())
    assert gap > 100 * ATOL, gap


def test_reversed_times_change_the_output():
    m = _model()
    hist, times = _histories([SEQ_LEN, 8], seed=5)
    flipped = [t[::-1] for t in times]
    gap = float((_port(m, hist, times) - _port(m, hist, flipped)).abs().max())
    assert gap > 100 * ATOL, gap
    torch.testing.assert_close(_port(m, hist, flipped), _reference(m, hist, flipped), rtol=0, atol=ATOL)


def test_the_position_index_is_the_public_codes():
    """``pos_w[N - 1 + j - i]``, against the public code's construction of
    ``rel_pos_bias`` (pad, repeat, reshape, slice) on ``pos_w = 0..2N-2``."""
    n = SEQ_LEN
    pos_w = torch.arange(2 * n - 1, dtype=torch.float32)
    t = torch.nn.functional.pad(pos_w[: 2 * n - 1], [0, n]).repeat(n)
    t = t[..., :-n].reshape(1, n, 3 * n - 2)
    r = (2 * n - 1) // 2
    public = t[:, :, r:-r][0]
    assert torch.equal(pos_w[hstu_position_index(n, n, "cpu")], public)
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    assert torch.equal(hstu_position_index(n, n, "cpu"), n - 1 + j - i)


def _boundaries():
    """Each bucket's first gap up to 2^31 s (by bisection on the reference's
    bucket), with its neighbours, signed both ways."""
    out = []
    for b in range(1, ref.BUCKETS + 1):
        lo, hi = 1, 2**31
        if int(ref.time_bucket(torch.tensor([hi]))) < b:
            break
        while lo < hi:
            mid = (lo + hi) // 2
            if int(ref.time_bucket(torch.tensor([mid]))) >= b:
                hi = mid
            else:
                lo = mid + 1
        out += [lo - 1, lo, lo + 1]
    return out


def test_bucket_boundaries_match_the_reference():
    gaps = torch.tensor(_boundaries() + [0, 1, 2**31 - 1, 2**31], dtype=torch.int64)
    assert len(gaps) > 3 * 70
    for sign in (1, -1):
        times = torch.cat([torch.zeros(1, dtype=torch.int64), sign * gaps])[None]  # bucket[i, 0] of gaps[i]
        got = hstu_time_buckets(times)[0, :, 0].long()
        assert torch.equal(got, ref.time_bucket(gaps))
    assert int(ref.time_bucket(torch.tensor([2**31]))) == 71


def test_a_users_representation_does_not_depend_on_its_batch():
    m = _model()
    hist, times = _histories([6, 1, SEQ_LEN, 30, 3], seed=13)
    batch = _port(m, hist, times)
    for r in range(len(hist)):
        alone = _port(m, hist[r : r + 1], times[r : r + 1])[0]
        torch.testing.assert_close(alone, batch[r], rtol=0, atol=1e-7)
    torch.testing.assert_close(_port(m, hist[::-1], times[::-1]), batch.flip(0), rtol=0, atol=1e-7)


def test_timestamps_are_checked():
    m = _model()
    hist, times = _histories([3, 4])
    with pytest.raises(ValueError, match="needs the histories' timestamps"):
        m.recommend_batch(hist)
    with pytest.raises(ValueError, match="needs the histories' timestamps"):
        m.user_representations(hist)
    with pytest.raises(ValueError, match="history 1 has 4 items but 3 timestamps"):
        m.recommend_batch(hist, timestamps=[times[0], times[1][:3]])
    with pytest.raises(ValueError, match="1 rows of timestamps for 2 histories"):
        m.recommend_batch(hist, timestamps=times[:1])
    for other in (lstm.Hyperparameters(NUM_ITEMS, SEQ_LEN), ewma.Hyperparameters(NUM_ITEMS, SEQ_LEN)):
        o = other.embedding_dim(DIM).from_seed(1).build("cpu")
        with pytest.raises(ValueError, match="reads no timestamps"):
            o.recommend_batch(hist, timestamps=times)
        with pytest.raises(ValueError, match="reads no timestamps"):
            o.user_representation(hist[0], times[0])
        assert len(o.recommend_batch(hist, k=3)) == 2


def test_fit_is_not_supported():
    data = Interactions(2, NUM_ITEMS, np.array([0, 0, 0, 1, 1, 1]), np.array([1, 2, 3, 4, 5, 6]),
                        np.arange(6)).to_compressed()
    with pytest.raises(NotImplementedError, match="no timestamps"):
        _model().fit(data)


def test_evaluation_passes_the_test_timestamps():
    """MRR, hit rate and NDCG of an HSTU model read the test interactions'
    times: its ranks are the reference's (each prefix's representation from
    its items and times, seen items at f32 min, ties counted against)."""
    m = _model()
    lengths = [2, 5, 9, 12, 20, 31, 1, 7]
    hist, times = _histories(lengths, seed=17)
    users = np.repeat(np.arange(len(lengths)), lengths)
    test = Interactions(len(lengths), NUM_ITEMS, users, np.concatenate(hist),
                        np.concatenate(times)).to_compressed()
    ranks = evaluation._ranks(m, test)
    want = []
    table = m._params["item_table"]
    for h, t in zip(hist, times):
        if len(h) < 2:
            continue
        rep = _reference(m, [h[:-1]], [t[:-1]])[0]
        scores = (table[:, :-1] @ rep + table[:, -1]).numpy()
        scores[h[:-1]] = np.finfo(np.float32).min
        want.append(int((scores >= scores[h[-1]]).sum()))
    assert ranks.tolist() == want
    assert evaluation.mrr_score(m, test) == pytest.approx(np.mean(1.0 / np.array(want)), rel=1e-12)
    assert evaluation.hit_rate_score(m, test, k=5) == pytest.approx(np.mean(np.array(want) <= 5))


def test_checkpoint_and_dict_round_trip(tmp_path):
    m = _model()
    hp = hstu.Hyperparameters.from_dict(m.hyper.to_dict())
    assert hp.to_dict() == m.hyper.to_dict()
    assert hp.to_dict()["model_type"] == "hstu" and (hp._num_layers, hp._num_heads) == (LAYERS, HEADS)
    m.save(str(tmp_path / "ckpt"))
    back = base.ImplicitSequenceModel.load(str(tmp_path / "ckpt"), "cpu")
    assert type(back) is hstu.ImplicitHSTUModel and back.hyper.to_dict() == m.hyper.to_dict()
    for (pa, a), (pb, b) in zip(flatten(back._params["tower"]), flatten(m._params["tower"])):
        assert pa == pb and torch.equal(a, b)
    hist, times = _histories([4, SEQ_LEN, 17], seed=19)
    assert back.recommend_batch(hist, k=5, return_scores=True, timestamps=times)[0] == m.recommend_batch(
        hist, k=5, return_scores=True, timestamps=times)[0]


def test_the_two_references_agree_bit_for_bit():
    """``tests/hstu_reference.py`` and the benchmark's copy
    ``gpubench/reference/hstu.py`` compute the same bits."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_hstu_reference", ROOT / "gpubench/reference/hstu.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    m = _model()
    leaves = _leaves(m)
    g = torch.Generator().manual_seed(23)
    x = torch.randn((3, SEQ_LEN, DIM), generator=g)
    times = torch.cumsum(torch.randint(1, 10**6, (3, SEQ_LEN + 1), generator=g), dim=1)
    assert torch.equal(ref.apply(CFG, leaves, x, times), bench.apply(CFG, leaves, x, times))

    class Timed(list):
        pass

    hist, ts = _histories([1, 6, SEQ_LEN, 25], seed=29)
    timed = []
    for h, t in zip(hist, ts):
        timed.append(Timed(h))
        timed[-1].times = t
    table = m._params["item_table"]
    assert torch.equal(_reference(m, hist, ts), bench.representations(CFG, leaves, lambda i: table[i], timed))
