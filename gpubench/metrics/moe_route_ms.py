"""Device ms a batch of the router's GEMM, sigmoid and top-k, the sort of the
token-expert pairs by expert, the gather of their rows and the weighted
combine of every MoE layer (``models/towers.py mla_moe_apply``, span
``sbr.moe.route``): the kernels launched inside it, matched to their device
records by correlation id. ``None`` where the program records no such span
or no kernel ran inside one."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    ks = spans.kernels_in(r["window"], "moe.route")
    if not units or not ks:
        return None
    return 1e3 * sum(sec for _, sec in ks) / units
