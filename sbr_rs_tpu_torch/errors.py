"""Typed errors mirroring the reference's error surface.

A copy of :mod:`sbr_rs_tpu.errors`: importing that module would run
``sbr_rs_tpu/__init__.py``, which imports jax, and this package never does.

Reference: ``src/lib.rs:84-97`` defines ``PredictionError::InvalidPredictionValue``
and ``FittingError::NoInteractions``; ``src/datasets.rs:17-22`` defines
``DatasetError``.
"""

from __future__ import annotations


class SbrError(Exception):
    """Base class for all framework errors."""


class PredictionError(SbrError):
    """Failed prediction due to a numerical fault.

    Reference: ``src/lib.rs:84-89`` — raised when a predicted score is
    non-finite (``src/models/sequence_model.rs:225-229``).
    """


class InvalidPredictionValue(PredictionError):
    """Invalid prediction value: non-finite or not a number."""

    def __init__(self, message: str = "Invalid prediction value: non-finite or not a number."):
        super().__init__(message)


class FittingError(SbrError):
    """Errors raised during model fitting.

    Reference: ``src/lib.rs:92-97``.
    """


class NoInteractions(FittingError):
    """No interactions were supplied.

    Reference: raised at ``src/models/sequence_model.rs:86-88`` when no
    training windows survive filtering.
    """

    def __init__(self, message: str = "No interactions were supplied."):
        super().__init__(message)


class NonFiniteLoss(FittingError):
    """Training loss became non-finite (NaN/inf).

    No reference counterpart (the reference returns whatever loss it
    computed); surfacing divergence early is a deliberate addition
    (SURVEY.md §5.3 — failure detection).
    """

    def __init__(self, message: str = "Training loss became non-finite (NaN/inf)."):
        super().__init__(message)


class DatasetError(SbrError):
    """Errors raised by the built-in dataset loaders.

    Reference: ``src/datasets.rs:17-22``.
    """
