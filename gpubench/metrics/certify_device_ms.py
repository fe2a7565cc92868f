"""Device ms a unit (a batch or a request) of the streamed top-k's
certificate (``models/base.py topk_streamed``, span ``sbr.topk.certify``):
the kernels launched inside it, matched to their device records by
correlation id: ``phase1_error_bound``'s ``aminmax`` over the whole table
and the small kernels of the bound and the comparison, and the FP32
recheck's where users run again. ``None`` where the program records no
such span or no kernel ran inside one."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    ks = spans.kernels_in(r["window"], "topk.certify")
    if not units or not ks:
        return None
    return 1e3 * sum(sec for _, sec in ks) / units
