"""Training observability: fit history, a profiler trace and a leveled
logger.

Counterpart of :mod:`sbr_rs_tpu.utils.metrics`:

* :class:`FitHistory` — per-epoch losses, example counts, and wall-clock
  throughput for the last ``fit`` call (``model.history``).
* :func:`trace` — a ``torch.profiler`` trace of a region, written for
  TensorBoard or Perfetto (the JAX package's wraps ``jax.profiler``).
* :class:`Logger` — minimal leveled stderr logger, configurable via
  ``SBR_LOG`` (``quiet`` | ``info`` | ``debug``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class FitHistory:
    """Metrics for one ``fit`` call.

    ``epoch_losses[i]`` is the summed masked loss of epoch ``i`` (the
    reference accumulates per-thread loss sums, ``src/models/
    sequence_model.rs:157-175``); ``examples_per_epoch`` counts supervised
    timesteps (reference "examples"); ``wall_s`` is whole-fit wall time,
    ending when the epoch losses reach the host.
    """

    epoch_losses: np.ndarray
    examples_per_epoch: int
    num_epochs: int
    wall_s: float

    @property
    def total_examples(self) -> int:
        return self.examples_per_epoch * self.num_epochs

    @property
    def examples_per_sec(self) -> float:
        return self.total_examples / self.wall_s if self.wall_s > 0 else float("nan")

    @property
    def mean_loss(self) -> float:
        """``loss_sum / (1 + examples)`` — the reference's fit return value."""
        return float(self.epoch_losses.sum()) / (1.0 + self.total_examples)

    def summary(self) -> str:
        losses = (
            f"loss {float(self.epoch_losses[0]):.4g} -> {float(self.epoch_losses[-1]):.4g}"
            if len(self.epoch_losses)
            else "no epochs ran"
        )
        return (
            f"fit: {self.num_epochs} epochs x {self.examples_per_epoch} examples "
            f"in {self.wall_s:.2f}s ({self.examples_per_sec:,.0f} ex/s), {losses}"
        )


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (a ``*.pt.trace.json`` file; view it with TensorBoard's
    profile plugin or Perfetto): the host's operators always, and the CUDA
    kernels and copies when a card is present. The region starts when the
    card has run what was launched before it and ends when the card has run
    what it launched.

    Known fault (torch 2.11 on an H100): in a process that has kept the
    card busy for a while, the trace can lack the region's first kernel
    records while every launch call is there (none lost after 300 short
    profiler sessions; 6-8 of 79 after 90 s of back-to-back matmuls, also
    after 30 s of idle time; 18 after ``chip_smoke.main()``), erratically
    from run to run. Neither this synchronisation nor a warm-up step
    (``schedule``), a 50 ms wait inside the profiler, ``TEARDOWN_CUPTI=0`` or
    a sleep kernel at the region's start keeps them (the sleep kernel is
    lost, and as many after it). A fresh process traces them all.
    ``scripts/torch_trace_probe.py`` checks it;
    ``scripts/torch_trace_probe.py --age`` reproduces it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()


_LEVELS = {"quiet": 0, "info": 1, "debug": 2}


class Logger:
    """Leveled stderr logger; level from ``SBR_LOG`` (default ``quiet``)."""

    def __init__(self, name: str = "sbr"):
        self.name = name
        self.level = _LEVELS.get(os.environ.get("SBR_LOG", "quiet").lower(), 0)

    def _emit(self, tag: str, msg: str) -> None:
        print(f"[{self.name}:{tag} {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr)

    def info(self, msg: str) -> None:
        if self.level >= 1:
            self._emit("info", msg)

    def debug(self, msg: str) -> None:
        if self.level >= 2:
            self._emit("debug", msg)


logger = Logger()
