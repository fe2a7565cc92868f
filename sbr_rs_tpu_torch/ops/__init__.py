"""Kernels of the port, each beside its plain PyTorch version:
:mod:`.lstm_kernels` (the LSTM recurrence, forward and backward),
:mod:`.hstu_kernels` (HSTU's layer norms, the gated one with its gate),
:mod:`.topk_kernels` (catalog scoring fused with a group-max, or with a
rank count) and :mod:`.row_kernels` (the training step's row gathers, row
read-modify-writes and WARP candidate scores). The CUDA sources are in ``csrc/``; :mod:`._build` compiles
them on the first CUDA call. Beside them, the plain PyTorch pieces of the
training step:
:mod:`.losses`, :mod:`.sampling` and :mod:`.optimizers`."""

from . import hstu_kernels, losses, lstm_kernels, optimizers, row_kernels, sampling, topk_kernels

__all__ = ["hstu_kernels", "losses", "lstm_kernels", "optimizers", "row_kernels", "sampling", "topk_kernels"]
