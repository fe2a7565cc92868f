"""Device ms a batch of each layer's RMSNorm and multi-head latent attention:
the q, kv_a, kv_b and o projections, the latent norm, RoPE, the padded
scores, mask, softmax and A v (``models/towers.py mla_moe_apply``, span
``sbr.moe.attention``): the kernels launched inside it, matched to their
device records by correlation id. ``None`` where the program records no such
span or no kernel ran inside one."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    ks = spans.kernels_in(r["window"], "moe.attention")
    if not units or not ks:
        return None
    return 1e3 * sum(sec for _, sec in ks) / units
