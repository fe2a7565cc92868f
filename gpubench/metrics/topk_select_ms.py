"""Device ms a batch of the top-k selections in the streamed top-k
(``models/base.py topk_streamed``): every kernel of ``torch.topk`` in the
window (their names hold ``topk``; phase 1's over the group maxima takes
nearly all of it), over the batches served."""

import re


def read(r, name):
    units = r.get("units") or 0
    ms = sum(sec for n, sec in r["window"].kernels() if re.search("(?i)topk", n)) * 1e3
    if not units or ms <= 0:
        return None
    return ms / units
