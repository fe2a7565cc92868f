"""Models module: shared enums, the user-representation type, the LSTM
family (:mod:`.lstm`) and the training engine (:mod:`.engine`).

Copies of the jax-free pieces of :mod:`sbr_rs_tpu.models` (importing that
package would load jax). The enum values are the JAX package's, so the
``config.json`` dicts of either package load in the other.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


@dataclasses.dataclass
class ImplicitUser:
    """The user representation used by implicit sequence models
    (reference ``src/models/mod.rs:9-12``)."""

    user_embedding: np.ndarray


class Loss(enum.Enum):
    """The loss used for training the model (reference ``src/models/mod.rs:15-23``)."""

    BPR = "bpr"
    HINGE = "hinge"
    WARP = "warp"


class Optimizer(enum.Enum):
    """Optimizer used to train the model (reference ``src/models/mod.rs:26-32``)."""

    ADAGRAD = "adagrad"
    ADAM = "adam"


class Parallelism(enum.Enum):
    """Type of parallelism used to train the model (reference
    ``src/models/mod.rs:34-41``). Kept for API parity; it changes nothing."""

    ASYNCHRONOUS = "asynchronous"
    SYNCHRONOUS = "synchronous"


from . import engine, lstm  # noqa: E402  (re-exported submodules)

__all__ = ["ImplicitUser", "Loss", "Optimizer", "Parallelism", "engine", "lstm"]
