"""Device ms a batch of HSTU's attention (``models/towers.py hstu_apply``,
span ``sbr.hstu.attention``): the kernels launched inside it, matched to
their device records by correlation id, every block's bias gather,
``Q K^T``, SiLU, mask and ``A V``. ``None`` where the program records no
such span or no kernel ran inside one."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    ks = spans.kernels_in(r["window"], "hstu.attention")
    if not units or not ks:
        return None
    return 1e3 * sum(sec for _, sec in ks) / units
