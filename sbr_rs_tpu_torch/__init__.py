"""sbr-rs-tpu on PyTorch and CUDA: the port of :mod:`sbr_rs_tpu` to NVIDIA
Hopper (H100), beside the JAX package it is held against.

So far it serves the LSTM family: user representations, ``predict`` and
the exact batched top-k of ``recommend_batch``, with the LSTM recurrence and
the catalog score + group-max as hand-written CUDA kernels (``csrc/``).
Training is not ported yet. This package imports torch and numpy, never jax.

Example::

    import torch
    from sbr_rs_tpu_torch.models import lstm

    model = (
        lstm.Hyperparameters(10_000_000, 32)
        .embedding_dim(127)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .from_seed(42)
        .build(torch.device("cuda"))
    )
    ids = model.recommend_batch([[1, 2, 3], [42]], k=10)
"""

from . import errors, models, ops

__all__ = ["errors", "models", "ops"]
