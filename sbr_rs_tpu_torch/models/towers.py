"""Sequence towers, the LSTM part: the encoder mapping input-item embeddings
to per-timestep user states. Counterpart of :mod:`sbr_rs_tpu.models.towers`.

The LSTM keeps the fused gate layout of the JAX package: ``w_x`` and ``w_h``
are ``[D, G*D]`` and ``b`` is ``[G*D]``, gate order ``[i, f, g, o]``
(Normal) or ``[i, g, o]`` (Coupled, forget = 1 - input; reference
``src/models/lstm.rs:28-35``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.lstm_kernels import lstm_fwd_plain, time_major_inputs


def init_lstm(
    generator: torch.Generator, dim: int, coupled: bool, device: torch.device
) -> Dict[str, torch.Tensor]:
    """LSTM cell parameters with fused gate matrices. Each gate's
    ``[dim, dim]`` block is Glorot-normal with per-gate fan, std
    ``sqrt(2 / (dim + dim))``, as in the JAX package; the bias is zero."""
    gates = 3 if coupled else 4
    std = (2.0 / (dim + dim)) ** 0.5

    def glorot():
        return std * torch.randn(
            (dim, gates * dim), generator=generator, device=device, dtype=torch.float32
        )

    w_x = glorot()
    w_h = glorot()
    b = torch.zeros((gates * dim,), dtype=torch.float32, device=device)
    return {"w_x": w_x, "w_h": w_h, "b": b}


def lstm_apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    coupled: bool,
    starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the LSTM over ``x [B, T, D]`` returning hidden states
    ``[B, T, D]``, in plain PyTorch on any device: one input projection for
    all timesteps, then a time loop with f32 carries. ``starts [B, T]``
    (packed batches) is 1.0 where a new window begins; the carries reset
    there."""
    xz, keep = time_major_inputs(params, x, starts)
    hidden, _ = lstm_fwd_plain(xz, params["w_h"], keep, coupled)
    return hidden.transpose(0, 1)
