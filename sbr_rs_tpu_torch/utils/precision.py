"""Full FP32 for the plain matmuls whose results must be FP32, scoped to them.

A float32 matmul on the card rounds its inputs to TF32 (about three decimal
digits) when ``torch.backends.cuda.matmul.allow_tf32`` is True. That flag is
the caller's: the port never sets it for the process, as the JAX package
sets no global precision. The matmuls of serving and evaluation (user
representations, phase 2 of the top-k, evaluation targets and the chunked
counter) run inside :func:`fp32_matmul`, which turns it off for their
duration and restores the caller's value.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Run the block with ``torch.backends.cuda.matmul.allow_tf32 = False``
    and restore the caller's setting afterwards, also on an exception."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
