"""Adagrad and lazy Adam with touched-row semantics. Counterpart of
:mod:`sbr_rs_tpu.ops.optimizers`.

The reference trains with wyrm's ``optim::{Adagrad, Adam}`` on sparse row
gradients (``src/models/lstm.rs:234-248``,
``src/models/sequence_model.rs:163-169``): only rows a step touched are
updated, and the L2 penalty applies to touched rows only. Two table
updates keep that rule, as in the JAX package:

* small catalogs: the whole table under a per-column touch mask
  (:func:`dense_row_update`);
* large catalogs: the touched rows alone. :func:`dedupe_and_sum` sorts the
  step's occurrences and sums each row's gradients; :func:`sparse_update`
  gathers the unique rows and their state (:func:`..ops.row_kernels.gather_rows`),
  updates them and adds the changes back in place
  (:func:`..ops.row_kernels.scatter_add_rows_`), so the traffic follows the
  batch, not the catalog.

Tower weights take the ordinary :func:`dense_update`.

Update rules:

* Adagrad:  ``acc += g²;  w -= lr * g / sqrt(acc + eps)``
* Adam (lazy on table rows): Adam moments with global-step bias correction;
  moments of untouched entries are not decayed.
* L2: ``g += l2 * w`` on touched entries before the update.

The updates change ``param``/``table`` and the state tensors IN PLACE and
return them: the JAX versions return new arrays, the values are the same.
Math runs in f32; the result is rounded to the storage dtype (bf16 tables
work). The step count ``step`` is a host integer, so the bias correction is
a host scalar.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import Optimizer
from .row_kernels import gather_rows, scatter_add_rows_

_ADAGRAD_EPS = 1e-10
_ADAM_B1 = 0.9
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8

State = Dict[str, torch.Tensor]


def init_state(kind: Optimizer, param: torch.Tensor) -> State:
    """Zero optimizer state shaped and typed like ``param``."""
    if kind == Optimizer.ADAGRAD:
        return {"acc": torch.zeros_like(param)}
    if kind == Optimizer.ADAM:
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}
    raise ValueError(f"Unknown optimizer: {kind}")


def _bias_correction(step: int) -> Tuple[float, float]:
    """Adam's ``1 - b1^t`` and ``1 - b2^t`` for ``t = step + 1``, rounded
    in f32 as the JAX package computes them (``1 - b2^t`` loses about five
    digits in f32 at t = 1; the port keeps the reference's value)."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    return float(one - np.float32(_ADAM_B1) ** t), float(one - np.float32(_ADAM_B2) ** t)


def dense_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    param: torch.Tensor,
    state: State,
    grad: torch.Tensor,
    step: int,
) -> Tuple[torch.Tensor, State]:
    """One step on a dense f32 parameter (tower weights), in place."""
    g = grad + l2 * param
    if kind == Optimizer.ADAGRAD:
        acc = state["acc"].addcmul_(g, g)
        param.sub_(lr * g / torch.sqrt(acc + _ADAGRAD_EPS))
        return param, state
    m = state["m"].mul_(_ADAM_B1).add_(g, alpha=1.0 - _ADAM_B1)
    v = state["v"].mul_(_ADAM_B2).addcmul_(g, g, value=1.0 - _ADAM_B2)
    c1, c2 = _bias_correction(step)
    param.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + _ADAM_EPS))
    return param, state


def dense_row_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    table: torch.Tensor,
    state: State,
    grad: torch.Tensor,
    touched: torch.Tensor,
    step: int,
    bias_touched: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """Full-table update with touched-rows-only semantics, in place: L2,
    state and step apply only where the batch touched.

    ``grad``: the dense f32 cotangent (scatter-add of row gradients, zeros
    elsewhere). ``touched``: bool ``[num_rows]``. ``bias_touched`` (fused
    ``[N, D+1]`` tables): rows whose LAST column (the bias) received a
    gradient. The reference keeps biases as a separate parameter that
    input-only occurrences never touch (``src/models/lstm.rs:272-291``), so
    the bias of a row touched only as an input sees no L2, no state update
    and no step.
    """
    if table.ndim == 1:
        t_mask = touched
    elif bias_touched is not None:
        t_mask = torch.cat(
            [touched[:, None].expand(-1, table.shape[1] - 1), bias_touched[:, None]], dim=1
        )
    else:
        t_mask = touched[:, None]
    dt = table.dtype
    g = grad + l2 * table.to(torch.float32) * t_mask
    if kind == Optimizer.ADAGRAD:
        acc = state["acc"].to(torch.float32) + g * g  # untouched entries add 0
        table.sub_((lr * g / torch.sqrt(acc + _ADAGRAD_EPS)).to(dt))
        state["acc"].copy_(acc)
        return table, state
    m_old = state["m"].to(torch.float32)
    v_old = state["v"].to(torch.float32)
    m = torch.where(t_mask, _ADAM_B1 * m_old + (1.0 - _ADAM_B1) * g, m_old)
    v = torch.where(t_mask, _ADAM_B2 * v_old + (1.0 - _ADAM_B2) * (g * g), v_old)
    c1, c2 = _bias_correction(step)
    upd = lr * (m / c1) / (torch.sqrt(v / c2) + _ADAM_EPS)
    table.sub_(torch.where(t_mask, upd, 0.0).to(dt))
    state["m"].copy_(m)
    state["v"].copy_(v)
    return table, state


# -- sparse path: touched rows only ---------------------------------------------------


class DedupedRows(NamedTuple):
    """A static-shape description of the unique rows a step touched
    (:func:`dedupe_rows`, :func:`dedupe_and_sum`).

    ``order`` sorts the occurrences (stably); ``seg_id[i]`` is the segment
    (unique row) of sorted occurrence ``i``; ``row_ids`` holds each slot's
    row id, ``num_rows`` for an invalid or unused slot (scatters drop it);
    ``valid`` marks the slots of real rows.
    """

    order: torch.Tensor  # [M] int64
    seg_id: torch.Tensor  # [M] int64
    row_ids: torch.Tensor  # [M] int64, num_rows = invalid
    valid: torch.Tensor  # [M] bool


def _sorted_occurrences(indices: torch.Tensor, occurrence_valid: torch.Tensor, num_rows: int):
    """Occurrences with invalid ones mapped to ``num_rows`` (so they sort
    last), sorted stably as ``jnp.argsort`` sorts: the order of equal ids
    sets the rounding of their sums. Returns ``(sorted ids, order, run
    starts)``."""
    masked = torch.where(occurrence_valid, indices.long(), num_rows)
    s, order = torch.sort(masked, stable=True)
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[1:] = s[1:] != s[:-1]
    return s, order, starts


def dedupe_rows(indices: torch.Tensor, occurrence_valid: torch.Tensor, num_rows: int) -> DedupedRows:
    """Deduplicate the touched row ids of ``indices`` (one per occurrence)
    in segment space: segment ``j`` is the ``j``-th distinct id in sorted
    order, and slots past the last segment are invalid. Invalid occurrences
    form one dropped segment of id ``num_rows``."""
    m = indices.shape[0]
    s, order, starts = _sorted_occurrences(indices, occurrence_valid, num_rows)
    seg_id = torch.cumsum(starts, dim=0) - 1
    row_ids = torch.full((m,), torch.iinfo(torch.int64).min, dtype=torch.int64, device=s.device)
    row_ids.scatter_reduce_(0, seg_id, s, reduce="amax")
    valid = (row_ids >= 0) & (row_ids < num_rows)
    return DedupedRows(order, seg_id, torch.where(valid, row_ids, num_rows), valid)


def segment_sum_grads(row_grads: torch.Tensor, dd: DedupedRows) -> torch.Tensor:
    """Per-segment sums of the per-occurrence gradients (``[M, ...]``)."""
    out = row_grads.new_zeros(row_grads.shape)
    return out.index_add_(0, dd.seg_id, row_grads[dd.order])


def _blocked_cumsum(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Inclusive cumsum along axis 0 in the JAX package's association: a
    cumsum inside each block of ``block`` rows, plus the running sum of the
    block totals before it. The association sets the rounding of the run
    sums of :func:`dedupe_and_sum`, and where a row's gradients nearly
    cancel, Adam's and Adagrad's first step turn that rounding into an
    update of about ``lr``; a plain ``torch.cumsum`` moved one entry of a
    two-epoch fit by 0.099 against the JAX package (``tests/test_torch_fit.py``,
    Coupled LSTM, BPR, Adam), this one by 8.5e-5."""
    m = x.shape[0]
    nb = -(-m // block)
    xp = x if nb * block == m else torch.cat([x, x.new_zeros((nb * block - m,) + tuple(x.shape[1:]))])
    inner = torch.cumsum(xp.reshape((nb, block) + tuple(x.shape[1:])), dim=1)
    totals = torch.cumsum(inner[:, -1], dim=0)
    offsets = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])  # exclusive
    return (inner + offsets[:, None]).reshape((nb * block,) + tuple(x.shape[1:]))[:m]


def dedupe_and_sum(
    indices: torch.Tensor,
    occurrence_valid: torch.Tensor,
    row_grads: torch.Tensor,
    bias_occ: torch.Tensor,
    num_rows: int,
) -> Tuple[DedupedRows, torch.Tensor, torch.Tensor]:
    """:func:`dedupe_rows` + :func:`segment_sum_grads` + per-row bias
    validity, in OCCURRENCE space: a row's slot is the last occurrence of
    its run in sorted order, and every other slot holds ``num_rows`` (so the
    sentinel repeats and the real ids are unique). A run's sum is
    ``cum[end] - cum[start - 1]``, the run start found by a binary search of
    the sorted ids (the JAX package takes a cummax; the positions are the
    same); it inherits rounding from the prefix before it, as the JAX
    package's does (:func:`_blocked_cumsum`). Every step is deterministic:
    the bias counts are sums of 0 and 1, exact in any order.

    ``row_grads [M, C]`` f32; ``bias_occ [M]`` bool (the occurrence touches
    the bias column). Returns ``(dd, summed [M, C], bias_valid [M])``, the
    bias flag meaningful at the live slots; ``dd.seg_id`` is zeros in this
    layout.
    """
    m = indices.shape[0]
    s, order, starts = _sorted_occurrences(indices, occurrence_valid, num_rows)
    gs = gather_rows(row_grads, order)
    ends = torch.ones_like(starts)
    ends[:-1] = starts[1:]
    start_pos = torch.searchsorted(s, s)  # the first position of each id: its run's start
    prev = start_pos - 1  # the last position before this run (-1: none)
    has_prev = (prev >= 0).to(torch.float32)
    cum = _blocked_cumsum(gs)
    summed = torch.addcmul(cum, gather_rows(cum, prev.clamp(min=0)), has_prev[:, None], value=-1.0)
    bias_count = torch.zeros((m,), dtype=torch.float32, device=s.device)
    bias_count.index_add_(0, start_pos, bias_occ[order].to(torch.float32))
    bias_valid = bias_count[start_pos] > 0.0
    live = ends & (s < num_rows)
    row_ids = torch.where(live, s, num_rows)
    return DedupedRows(order, torch.zeros_like(start_pos), row_ids, live), summed, bias_valid


def sparse_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    table: torch.Tensor,
    state: State,
    dd: DedupedRows,
    summed_grads: torch.Tensor,
    step: int,
    bias_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """One step on the unique touched rows of ``table``, in place.

    ``summed_grads``: per-slot gradients shaped like ``table[dd.row_ids]``.
    ``bias_valid`` (fused ``[N, D+1]`` tables): per slot, whether the row's
    last (bias) column received a gradient; a valid row without it gets no
    L2, state or step on that column (see :func:`dense_row_update`).

    The rows and their state are gathered before anything is written; the
    changes are cast to the storage dtype and added back over the unique ids
    (the sentinel slots are dropped). Lazy Adam adds the moments' change
    ``(new - old) * mask`` rather than overwriting them, as the JAX package
    does: entries outside the mask keep their moments, and a bf16 state
    rounds the same way in both packages.
    """
    if table.ndim == 1:
        table2 = table[:, None]
        sg = summed_grads[:, None]
        state2 = {k: v[:, None] for k, v in state.items()}
    else:
        table2, sg, state2 = table, summed_grads, state
    dt = table2.dtype
    ids = dd.row_ids
    vcol = dd.valid[:, None].to(torch.float32)
    w_rows = gather_rows(table2, ids)
    if bias_valid is None:
        mcol = vcol
    else:
        mcol = torch.cat(
            [vcol.expand(-1, w_rows.shape[1] - 1), (dd.valid & bias_valid)[:, None].to(torch.float32)],
            dim=1,
        )
    g = sg + l2 * w_rows * mcol
    if kind == Optimizer.ADAGRAD:
        acc = state2["acc"]
        acc_new = gather_rows(acc, ids) + g * g
        upd = lr * g / torch.sqrt(acc_new + _ADAGRAD_EPS)
        scatter_add_rows_(table2, ids, (-upd * mcol).to(dt))
        scatter_add_rows_(acc, ids, (g * g * mcol).to(acc.dtype))
        return table, state
    m_st, v_st = state2["m"], state2["v"]
    m_rows = gather_rows(m_st, ids)
    v_rows = gather_rows(v_st, ids)
    m_new = _ADAM_B1 * m_rows + (1.0 - _ADAM_B1) * g
    v_new = _ADAM_B2 * v_rows + (1.0 - _ADAM_B2) * (g * g)
    c1, c2 = _bias_correction(step)
    upd = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + _ADAM_EPS)
    scatter_add_rows_(table2, ids, (-upd * mcol).to(dt))
    scatter_add_rows_(m_st, ids, ((m_new - m_rows) * mcol).to(m_st.dtype))
    scatter_add_rows_(v_st, ids, ((v_new - v_rows) * mcol).to(v_st.dtype))
    return table, state
