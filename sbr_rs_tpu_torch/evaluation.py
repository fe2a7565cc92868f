"""Evaluation: mean reciprocal rank, hit rate and NDCG over full-catalog
scoring. Counterpart of :mod:`sbr_rs_tpu.evaluation`.

Reference protocol (``src/evaluation.rs:12-48``): for every test user with
at least 2 interactions, build a representation from all but the last
item, score the *entire catalog*, mask already-seen items to ``f32::MIN``
and rank the held-out item with ties counted against the model
(``prediction >= test_score`` includes the item itself, so rank >= 1).

For an :class:`ImplicitSequenceModel` users go in batches, and one of two
counters ranks a batch against the catalog on the model's device:

* :func:`_count_catalog_chunked` scores the catalog in ``[U, chunk]``
  slabs of ``_ITEM_CHUNK`` items, masks seen items in each and counts;
* :func:`_count_catalog_fused` counts the whole catalog in one call of
  the fused score + count kernel (:func:`.ops.topk_kernels.score_count_ge`,
  ``csrc/score_count.cu`` on the GPU), which never writes a score to
  device memory, then corrects for the seen items in O(U·P).

The fused counter runs whenever the catalog needs more than one chunk (and
the kernel takes the row width), on any device: on ``cuda`` that launches
the kernel, on ``cpu`` its plain version. Single-chunk catalogs take the
chunked counter, unless the table is row-sharded.

On a table row-sharded over a mesh's ``model`` axis (the JAX package's
``shard_count``), every catalog takes the fused counter: each rank runs K5
on its own slab (``lo`` its first row, ``n`` the catalog, so a short last
slab is masked by ``n``), the counts are summed over the model group, the
probe score comes from the slab that owns the held-out item, and the
targets and the seen correction read rows through the sharded gather. The
ranks are those of the unsharded table, and every rank returns them.

Unlike the JAX module, batches are not padded to a fixed shape (PyTorch
runs eagerly, so there is no program to reuse), and out-of-range ids are
refused on the host before any gather. The plain
matmuls (targets, the chunked counter's slabs, the seen correction) run in
full FP32 whatever the caller's ``allow_tf32`` (:mod:`.utils.precision`).
"""

from __future__ import annotations

import numpy as np
import torch

from .data import CompressedInteractions
from .errors import InvalidPredictionValue
from .models.base import ImplicitSequenceModel, _seen_rows
from .ops.topk_kernels import count_supported, score_count_ge
from .parallel.mesh import MODEL_AXIS
from .parallel.sharding import owner_sum, read_rows, slab_range, to_local
from .utils.precision import fp32_matmul

_NEG_MIN = float(np.finfo(np.float32).min)

_USER_BATCH = 512  # bounds the chunked counter's [U, chunk] score matrix
# The fused counter streams the table once per batch and keeps no score
# matrix, so it takes wide batches.
_USER_BATCH_FUSED = 4096
_ITEM_CHUNK = 65536


def mrr_score(model, test: CompressedInteractions) -> float:
    """Mean reciprocal rank of the held-out next items (reference
    ``src/evaluation.rs:12``); ``nan`` when no user qualifies."""
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    return float(np.mean(1.0 / ranks.astype(np.float64)))


def hit_rate_score(model, test: CompressedInteractions, k: int = 10) -> float:
    """Fraction of held-out items ranked in the top ``k`` (``rank <= k``),
    under the protocol of :func:`mrr_score`."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    return float(np.mean(ranks <= k))


def ndcg_score(model, test: CompressedInteractions, k: int = 10) -> float:
    """NDCG @ ``k`` for the single held-out item: the mean of
    ``1 / log2(1 + rank)`` for ranks within ``k``, else 0."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    r = ranks.astype(np.float64)
    return float(np.mean(np.where(r <= k, 1.0 / np.log2(1.0 + r), 0.0)))


def _ranks(model, test: CompressedInteractions) -> np.ndarray:
    """Rank of each qualifying test user's held-out item (1 = top)."""
    if isinstance(model, ImplicitSequenceModel):
        return _ranks_batched(model, test)
    return _ranks_generic(model, test)


def _targets(table, reps, test_items, test_in_prefix, mesh=None, total_rows=None) -> torch.Tensor:
    """Each user's masked score of its held-out item: ``f32 min`` when the
    item was already seen (the reference masks before it reads the score)."""
    rows_t = read_rows(table, test_items, mesh, total_rows)
    with fp32_matmul():
        raw = (reps * rows_t[:, :-1]).sum(dim=1) + rows_t[:, -1]
    return torch.where(test_in_prefix, torch.full_like(raw, _NEG_MIN), raw)


def _count_catalog_chunked(table, reps, prefix, test_items, test_in_prefix, num_items, chunk):
    """``(counts, self_hits, targets)`` from ``[U, chunk]`` score slabs.

    ``counts[u]`` is the number of catalog items whose masked score is
    ``>= targets[u]``; ``self_hits[u]`` is 1 when the held-out item counted
    itself, judged by the chunk's own score of it (the separately computed
    target may differ by rounding). The last chunk's start is clamped so
    that it fits, and ``col_lo`` drops the columns the previous chunk
    already counted."""
    u = reps.shape[0]
    dev = reps.device
    targets = _targets(table, reps, test_items, test_in_prefix)
    counts = torch.zeros((u,), dtype=torch.int64, device=dev)
    self_hits = torch.zeros_like(counts)
    cols = torch.arange(chunk, device=dev)
    users = torch.arange(u, device=dev)
    for c in range(-(-num_items // chunk)):
        lo = min(c * chunk, num_items - chunk)
        col_lo = c * chunk - lo
        rows = table[lo : lo + chunk].to(torch.float32)
        with fp32_matmul():
            scores = reps @ rows[:, :-1].T + rows[:, -1]
        # Seen ids of this chunk become f32 min. Every other id (and the pad
        # value) goes to a spare column past the chunk, which is dropped:
        # a scatter on the GPU does not skip out-of-range indices.
        local = prefix - lo
        local = torch.where((local >= 0) & (local < chunk), local, chunk)
        seen = torch.zeros((u, chunk + 1), dtype=torch.bool, device=dev).scatter_(1, local, True)
        scores.masked_fill_(seen[:, :chunk], _NEG_MIN)
        counts += ((scores >= targets[:, None]) & (cols >= col_lo)).sum(dim=1)
        test_local = test_items - lo
        in_window = (test_local >= col_lo) & (test_local < chunk)
        self_score = scores[users, test_local.clamp(0, chunk - 1)]
        self_hits += (in_window & (self_score >= targets)).long()
    return counts, self_hits, targets


def _count_catalog_fused(table, reps, prefix, test_items, test_in_prefix, num_items, mesh=None, total_rows=None):
    """``(counts, self_hits, targets)`` as :func:`_count_catalog_chunked`
    gives them, from one whole-catalog :func:`score_count_ge` call (under a
    model axis, one call on this rank's slab of the ``total_rows``-row
    table, summed over the model group).

    The kernel counts *unmasked* scores ``>= target`` and returns each
    user's own score of its held-out item (the probe). The seen correction
    then subtracts each distinct seen id whose score clears the target
    (``prefix`` holds distinct ids) and adds the seen ids back when the
    target is the mask value itself (a held-out item already seen), which
    is exactly mask-then-count. The correction scores rows with the same
    bias-augmented f32 dot; a last-ulp difference between it and the
    kernel can flip one ``>=`` only at an exact tie."""
    u = reps.shape[0]
    targets = _targets(table, reps, test_items, test_in_prefix, mesh, total_rows)
    reps_aug = torch.cat([reps, reps.new_ones((u, 1))], dim=1).contiguous()
    if mesh is None or mesh.model == 1:
        counts_all, probe = score_count_ge(table, reps_aug, targets, test_items, 0, 0, num_items)
    else:
        lo, hi = slab_range(mesh, total_rows)
        local, in_slab = to_local(test_items, lo, hi)
        counts_all, probe = score_count_ge(table, reps_aug, targets, local, lo, 0, num_items)
        mesh.all_reduce(counts_all, MODEL_AXIS)
        probe = owner_sum(probe, in_slab, mesh)

    p = prefix.shape[1]
    seen_rows = read_rows(table, prefix.clamp(0, num_items - 1).reshape(-1), mesh, total_rows).reshape(u, p, -1)
    with fp32_matmul():
        seen_sc = torch.bmm(seen_rows, reps_aug[:, :, None])[:, :, 0]
    valid = prefix < num_items
    seen_ge = ((seen_sc >= targets[:, None]) & valid).sum(dim=1)
    n_seen = valid.sum(dim=1)
    counts = counts_all - seen_ge + torch.where(targets <= _NEG_MIN, n_seen, 0)
    self_hits = torch.where(test_in_prefix, 1, (probe >= targets).long())
    return counts, self_hits, targets


def _batch_inputs(model, test: CompressedInteractions, users: np.ndarray, num_items: int):
    """Device tensors for one batch of qualifying users: ``reps [U, D]``
    of their prefixes (every item but the last; with their timestamps for a
    family whose tower reads times), ``prefix [U, P]`` each
    user's distinct seen ids ascending and padded with ``num_items``,
    ``test_items [U]`` and ``test_in_prefix [U]``."""
    dev = model.device
    ptr = test.user_pointers
    starts, ends = ptr[users], ptr[users + 1] - 1  # the prefix ends before the last item
    lens = (ends - starts).astype(np.int64)
    offsets = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    at = offsets + np.arange(int(lens.sum()))
    flat = test.item_ids[at].astype(np.int64)
    times = test.timestamps[at].astype(np.int64) if model._reads_times else None
    test_items = test.item_ids[ends].astype(np.int64)
    n_rows = model.hyper._num_items
    if flat.size and (flat.min() < 0 or flat.max() >= n_rows):
        raise InvalidPredictionValue(f"History contains item ids outside [0, {n_rows}).")

    reps = model._representations(flat, lens, times)
    if not bool(torch.isfinite(reps).all()):
        raise InvalidPredictionValue()

    # Distinct seen ids: sorted rows, repeats replaced by the pad value.
    seen = _seen_rows(flat, lens, num_items, max(int(lens.max()), 1))
    seen.sort(axis=1)
    seen[:, 1:][seen[:, 1:] == seen[:, :-1]] = num_items
    seen.sort(axis=1)
    seen = seen[:, : max(int((seen < num_items).sum(axis=1).max()), 1)]
    test_in_prefix = (seen == test_items[:, None]).any(axis=1)
    return reps, *(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (seen, test_items, test_in_prefix)
    )


def _ranks_batched(model: ImplicitSequenceModel, test: CompressedInteractions) -> np.ndarray:
    """Ranks of every user with at least 2 items, batch by batch on the
    model's device (module docstring)."""
    num_items = test.num_items
    table = model._params["item_table"]  # this rank's slab under a model axis
    mesh, total_rows = model.hyper._mesh, model.hyper._num_items
    sharded = mesh is not None and mesh.model > 1
    if num_items > total_rows:
        raise ValueError(f"the test set has {num_items} items, the model {total_rows}")
    users = np.flatnonzero(np.diff(test.user_pointers) >= 2)
    if not len(users):
        return np.zeros((0,), dtype=np.int64)
    held_out = test.item_ids[test.user_pointers[users + 1] - 1]
    if held_out.min() < 0 or held_out.max() >= num_items:
        raise InvalidPredictionValue(f"Held-out item ids outside [0, {num_items}).")

    item_chunk = min(_ITEM_CHUNK, num_items)
    supported = count_supported(num_items, table.shape[1], 1)
    if sharded and not supported:
        raise ValueError(f"the fused counter does not take rows of {table.shape[1]} columns")
    fused = sharded or (-(-num_items // item_chunk) > 1 and supported)
    user_batch = _USER_BATCH_FUSED if fused else _USER_BATCH

    all_ranks = []
    for start in range(0, len(users), user_batch):
        inputs = _batch_inputs(model, test, users[start : start + user_batch], num_items)
        if fused:
            counts, self_hits, targets = _count_catalog_fused(table, *inputs, num_items, mesh, total_rows)
        else:
            counts, self_hits, targets = _count_catalog_chunked(table, *inputs, num_items, item_chunk)
        # A non-finite target (non-finite parameters) would fake a
        # near-perfect rank; the mask value f32 min is finite.
        if not bool(torch.isfinite(targets).all()):
            raise InvalidPredictionValue(
                "Non-finite target scores during evaluation (non-finite parameters)."
            )
        # rank = 1 (the item itself; ties count against) + other items >= it.
        all_ranks.append((1 + counts - self_hits).cpu().numpy().astype(np.int64))
    return np.concatenate(all_ranks)


def _ranks_generic(model, test: CompressedInteractions) -> np.ndarray:
    """Any object with ``user_representation`` and ``predict``: the
    reference's per-user loop, one full-catalog ``predict`` per user."""
    item_ids = np.arange(test.num_items)
    ranks = []
    for user in test.iter_users():
        if len(user) < 2:
            continue
        train_items = user.item_ids[:-1]
        test_item = int(user.item_ids[-1])
        rep = model.user_representation(train_items)
        predictions = np.array(model.predict(rep, item_ids), dtype=np.float32)
        predictions[train_items] = _NEG_MIN
        test_score = predictions[test_item]
        ranks.append(int(np.sum(predictions >= test_score)))
    return np.asarray(ranks, dtype=np.int64)
