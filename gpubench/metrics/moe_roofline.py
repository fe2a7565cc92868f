"""The MLA + MoE tower's share of its roofline (``models/towers.py
mla_moe_apply``, span ``sbr.moe.tower``): the least time the window's
towers need, over the device time of the kernels launched inside the span.
The work is counted once from shapes, however the tower is implemented:
the operations over the valid positions and the causal keys they attend
(``families/<family>.py tower_flops``), the bytes of the inputs (the valid
positions' f32 rows and each window's int64 length) read once, the weights
read once a batch, and ``[U, D]`` written once. ``None`` where the program
records no such span or the traffic counts no positions."""

import numpy as np

from gpubench import flops, spans, spec


def read(r, name):
    units, users = r.get("units") or 0, r.get("users") or 0
    positions, keys = r.get("tower_positions"), r.get("tower_keys")
    device_s = sum(sec for _, sec in spans.kernels_in(r["window"], "moe.tower"))
    if not units or not positions or device_s <= 0:
        return None
    cfg = r["cfg"]
    family = spec.family_module(cfg["family"])
    d = int(cfg["embedding_dim"])
    weights = 4.0 * sum(int(np.prod(shape)) for _, shape, _, _ in family.tower_shapes(cfg))
    nbytes = positions * d * 4.0 + users * (8.0 + d * 4.0) + units * weights
    bound, _ = flops.bound_s(family.tower_flops(cfg, positions, keys), nbytes)
    return 100.0 * bound / device_s
