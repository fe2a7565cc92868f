"""Models module: shared enums, the user-representation type, the
``OnlineRankingModel`` protocol, the six families (:mod:`.lstm`,
:mod:`.ewma`, :mod:`.gru`, :mod:`.attention`, :mod:`.hstu`, :mod:`.mla_moe`)
and the training engine (:mod:`.engine`).

Copies of the jax-free pieces of :mod:`sbr_rs_tpu.models` (importing that
package would load jax). The enum values are the JAX package's, so the
``config.json`` dicts of either package load in the other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class OnlineRankingModel(Protocol):
    """Structural protocol of the reference's core trait
    (``src/lib.rs:101-116``): anything with these two methods can be scored
    by :func:`sbr_rs_tpu_torch.evaluation.mrr_score`."""

    def user_representation(self, item_ids: Sequence[int]) -> "ImplicitUser":
        """Compute a user representation from an interaction history."""
        ...

    def predict(self, user: "ImplicitUser", item_ids: Sequence[int]) -> np.ndarray:
        """Given a user representation, rank ``item_ids`` by score."""
        ...


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


from . import attention, engine, ewma, gru, hstu, lstm, mla_moe  # noqa: E402  (re-exported submodules)

__all__ = [
    "ImplicitUser",
    "OnlineRankingModel",
    "Loss",
    "Optimizer",
    "Parallelism",
    "attention",
    "engine",
    "ewma",
    "gru",
    "hstu",
    "lstm",
    "mla_moe",
]
