"""The serving path's spans (``utils.metrics.span``), on the CPU.

Under a CPU ``torch.profiler`` session one ``recommend_batch`` call
records one ``sbr.recommend_batch`` root and, inside it, each stage's span
nested in its parent, on every top-k route: the dense top-k, the streamed
single pass with subgroups, its group-only form, the running merge, wide
seen lists, and both streamed routes with every user sent to the FP32
recheck. ``sbr.topk.recheck`` appears exactly when
``topk_streamed.rechecked_users`` moves, and the ids and scores are the
bits of the same call with no profiler. With no profiler a span is one
shared null context, and no profiler range is made.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sbr_rs_tpu_torch.models import base, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.utils import metrics

SEQ_LEN = 8
DIM = 16
K = 6
PREFIX = metrics.SPAN_PREFIX

# The top level of every call: (span, parent) -> count.
TOP = {
    ("serve.prepare", "recommend_batch"): 2,
    ("serve.budgets", "recommend_batch"): 1,
    ("serve.tower", "recommend_batch"): 1,
    ("tower.inputs", "serve.tower"): 1,
    ("serve.topk", "recommend_batch"): 1,
    ("serve.to_host", "recommend_batch"): 1,
}
STREAMED = {("topk.route", "serve.topk"): 1, ("topk.certify", "serve.topk"): 1}
SUBMAX = {("topk.phase1", "serve.topk"): 1, ("topk.winners", "serve.topk"): 1, ("topk.phase2", "serve.topk"): 1}
SUBMAX_RECHECK = {("topk.recheck", "topk.certify"): 1, ("topk.phase1", "topk.recheck"): 1,
                  ("topk.winners", "topk.recheck"): 1, ("topk.phase2", "topk.recheck"): 1}
# The group-only routes: the reps' split, then the K3 calls inside the winners
# (one in the single pass, one a chunk in the merge: 3 chunks of 2,048 rows).
GROUP_RECHECK = {("topk.recheck", "topk.certify"): 1, ("topk.winners", "topk.recheck"): 1,
                 ("topk.phase2", "topk.recheck"): 1}


def _group(k3_calls, recheck=False):
    spans = {("topk.phase1", "serve.topk"): 1, ("topk.winners", "serve.topk"): 1,
             ("topk.phase1", "topk.winners"): k3_calls, ("topk.phase2", "serve.topk"): 1}
    if recheck:
        spans.update(GROUP_RECHECK)
        spans[("topk.phase1", "topk.winners")] += k3_calls
    return spans


# route -> (catalog, class constants, wide seen lists, every user rechecked,
# the route's spans under serve.topk)
ROUTES = {
    "small": (1000, {}, False, False, {("topk.small", "serve.topk"): 1}),
    "single_pass": (5000, {}, False, False, {**STREAMED, **SUBMAX}),
    "single_pass_recheck": (5000, {}, False, True, {**STREAMED, **SUBMAX, **SUBMAX_RECHECK}),
    "group_single_pass": (5000, {"_SUBGROUP_TARGET": 128}, False, False, {**STREAMED, **_group(1)}),
    "running_merge": (5000, {"_MERGE_BUFFER_BYTES": 0}, False, False, {**STREAMED, **_group(3)}),
    "running_merge_recheck": (5000, {"_MERGE_BUFFER_BYTES": 0}, False, True,
                              {**STREAMED, **_group(3, recheck=True)}),
    # Wide seen lists: one dense top-k a slab of 2,048 rows, then their merge.
    "wide_seen": (5000, {}, True, False, {("topk.small", "serve.topk"): 3, ("topk.merge", "serve.topk"): 1}),
}


def _model(num_items, seed=0):
    return lstm.Hyperparameters(num_items, SEQ_LEN).embedding_dim(DIM).from_seed(seed).build("cpu")


def _histories(num_items, wide, seed=1):
    rng = np.random.default_rng(seed)
    hs = [[], [1, 2, 3], list(range(20)), [num_items - 1]]
    hs += [rng.integers(0, num_items, rng.integers(2, 12)).tolist() for _ in range(6)]
    if wide:  # seen lists past the post-filter limit of 128
        hs += [rng.integers(0, num_items, 150).tolist()]
    return hs


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


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_each_route_records_its_spans_nested_in_their_parents(route, monkeypatch):
    num_items, constants, wide, recheck, expected = ROUTES[route]
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 2048)
    for name, value in constants.items():
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    if recheck:  # a bound no user's list can meet: every user runs again in FP32
        monkeypatch.setattr(base, "phase1_error_bound", lambda table, reps_aug: torch.full((reps_aug.shape[0],), 1e30))
    model = _model(num_items)
    hs = _histories(num_items, wide)
    want_ids, want_scores = model.recommend_batch(hs, k=K, return_scores=True)

    before = base.topk_streamed.rechecked_users
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, scores = model.recommend_batch(hs, k=K, return_scores=True)
    rechecked = base.topk_streamed.rechecked_users - before

    assert ids == want_ids
    assert scores.tobytes() == want_scores.tobytes()
    got = collections.Counter(_spans(prof))
    assert got[("recommend_batch", None)] == 1
    del got[("recommend_batch", None)]
    assert dict(got) == {**TOP, **expected}
    assert (("topk.recheck", "topk.certify") in got) == (rechecked > 0)
    assert rechecked == (len(hs) if recheck else 0)


class _Counted:
    """A stand-in for the profiler's range that counts its constructions."""

    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counted)
    monkeypatch.setattr(_Counted, "made", 0)
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 2048)
    model = _model(5000)
    model.recommend_batch(_histories(5000, wide=False), k=K)
    assert _Counted.made == 0
    assert metrics.span("serve.topk") is metrics.span("topk.certify")
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("serve.topk"):
            pass
    assert _Counted.made == 1
