"""Utilities: checkpoints (:mod:`.checkpoint`, on the flax format codec
:mod:`.msgpack_codec`), the fit history, logger and profiler trace
(:mod:`.metrics`), and parameter exchange with the JAX package
(:mod:`.convert`)."""

from . import checkpoint, metrics

__all__ = ["checkpoint", "metrics"]
