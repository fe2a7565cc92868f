"""The plain reference: the towers and the full-catalog top-k in plain
PyTorch, float32, with TF32 off unless a control asks for it.
It imports nothing of the program under test; its weights are drawn again
from the seed (``gpubench.weights``), and its inputs are the ones the
benchmark handed the program."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and convolutions in FP32 (``tf32=False``) or TF32 for the
    enclosed region; the flags are restored after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
