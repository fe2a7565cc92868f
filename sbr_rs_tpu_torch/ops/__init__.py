"""Kernels of the port, each beside its plain PyTorch version:
:mod:`.lstm_kernels` (the LSTM recurrence) and :mod:`.topk_kernels`
(catalog scoring fused with a group-max). The CUDA sources are in
``csrc/``; :mod:`._build` compiles them on the first CUDA call."""

from . import lstm_kernels, topk_kernels

__all__ = ["lstm_kernels", "topk_kernels"]
