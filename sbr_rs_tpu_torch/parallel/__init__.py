"""Parallelism over ranks: the ``(data, model)`` mesh, the sharding rules
and multi-process start-up. Counterpart of :mod:`sbr_rs_tpu.parallel`.

The JAX package runs SPMD over a ``jax.sharding.Mesh`` with a ``data`` axis
(batch parallelism) and a ``model`` axis (the row-sharded item table), and
XLA inserts the collectives. Here one process runs each rank of a
``torch.distributed`` process group, and the model calls the collectives
itself (:mod:`.mesh`, :mod:`.sharding`); :mod:`.distributed` starts the
processes' group.
"""

from .distributed import global_mesh, initialize, is_primary, shutdown
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from .sharding import batch_sharding, batch_slice, shard_model_params

__all__ = [
    "make_mesh",
    "shard_model_params",
    "batch_slice",
    "batch_sharding",
    "Mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
    "initialize",
    "global_mesh",
    "is_primary",
    "shutdown",
]
