"""K4's share of its roofline (``ops/topk_kernels.py score_submax_groupmax``,
``csrc/score_submax_tc.cu`` in its two-output mode): the least time the
function needs for the window's calls (each user's scores of the whole
catalog, the table read once per call, the maxima written once, at the
subgroup and group widths the route chose), over K4's device time in the
trace. ``None`` where no K4 ran."""

from gpubench import flops
from gpubench.trace import short_name


def _is_k4(name: str) -> bool:
    short = short_name(name, 400)
    if "score_submax_kernel" not in short:
        return False
    return short.rstrip(">").split(",")[-1].strip() == "true"  # the kTwo template flag


def read(r, name):
    device_s = sum(sec for n, sec in r["window"].kernels() if _is_k4(n))
    calls = r["counters"].get("score_submax_groupmax", 0)
    if device_s <= 0 or not calls or r.get("route") is None:
        return None
    route, _ = r["route"]
    cfg = r["cfg"]
    n, cc = int(cfg["num_items"]), int(cfg["embedding_dim"]) + 1
    itemsize = 2 if cfg["table_dtype"] == "bfloat16" else 4
    users_per_call = r["users"] / calls
    one, _ = flops.bound_s(
        flops.catalog_scores(n, users_per_call, cc),
        flops.k4_bytes(n, users_per_call, cc, itemsize, route.sub, route.group),
    )
    return 100.0 * one * calls / device_s
