"""Adagrad and lazy Adam with touched-row semantics, dense path. Counterpart
of the dense half of :mod:`sbr_rs_tpu.ops.optimizers`.

The reference trains with wyrm's ``optim::{Adagrad, Adam}`` on sparse row
gradients (``src/models/lstm.rs:234-248``,
``src/models/sequence_model.rs:163-169``): only rows a step touched are
updated, and the L2 penalty applies to touched rows only. Here the whole
table is updated under a per-column touch mask (:func:`dense_row_update`),
which is what the JAX package does for small catalogs; tower weights take
the ordinary :func:`dense_update`.

Update rules:

* Adagrad:  ``acc += g²;  w -= lr * g / sqrt(acc + eps)``
* Adam (lazy on table rows): Adam moments with global-step bias correction;
  moments of untouched entries are not decayed.
* L2: ``g += l2 * w`` on touched entries before the update.

Both functions update ``param``/``table`` and the state tensors IN PLACE and
return them: the JAX versions return new arrays, the values are the same.
Math runs in f32; the result is rounded to the storage dtype (bf16 tables
work). The step count ``step`` is a host integer, so the bias correction is
a host scalar. The sparse path (``dedupe_rows``, ``dedupe_and_sum``,
``sparse_update``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import Optimizer

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
