"""Shared fluent hyperparameters and the implicit sequence-model base class.
Counterpart of :mod:`sbr_rs_tpu.models.base`.

What is here: the fluent ``Hyperparameters`` (their dicts load in either
package), ``fit``, user representations, ``predict``, and
``recommend_batch`` with the exact top-k of the JAX package.

Training (``fit``): windows are extracted and laid out on the host once
(cached per interactions object), moved to the device with a zero-mask
sentinel row, and each epoch walks a fresh permutation in minibatches of
:func:`.engine.make_train_step`. The randomness (epoch permutations,
negative candidates) comes from one ``torch.Generator`` on the model's
device, seeded from the model's seed after the parameter draws and carried
across ``fit`` calls. A tower with train-time dropout draws its masks from a
second generator of the model's own, so the permutations and candidates do
not depend on it; ``clone()`` copies both generators' states.

The tower's parameters are a tree (nested dicts and lists of tensors, walked
by :mod:`..utils.tree`): flat for the recurrent towers, per-layer lists for
attention.

Serving (``recommend_batch``):

* catalogs of at most ``_SERVE_ITEM_CHUNK`` items: one dense ``[U, N]``
  score matrix and one top-k (:func:`topk_small`); a batch of at least
  ``2 * PIPELINE_MIN_USERS`` users runs as sub-batches in a pipeline, the
  host preparing one while the card runs the one before
  (:meth:`ImplicitSequenceModel._pipeline_parts`);
* larger catalogs: the exact two-phase selection (:func:`topk_streamed`).
  Phase 1 keeps the top ``k + S`` groups by group maximum from the fused
  score + group-max kernels (:mod:`..ops.topk_kernels`, on the tensor
  cores in 3xTF32), over the whole catalog in one call when the maxima fit
  the merge budget (with subgroup refinement), else chunk by chunk
  with a running merge. Each user's result is certified against the FP32
  one, and the few it cannot certify run again in FP32. Phase 2 re-scores
  the kept candidates in f32, drops seen items by id and takes the exact
  top-k;
* seen lists wider than ``_SERVE_MAX_POSTFILTER_SEEN``: the catalog in
  slabs of ``_SERVE_ITEM_CHUNK`` rows, each slab's dense top-k as a catalog
  of its own (:func:`topk_slab` over :func:`topk_small`), then one exact
  merge of the slabs' lists (:func:`merge_topk_parts`), as a row-sharded
  table is served.

The budgets that pick the route and size its buffers are the JAX package's
on the CPU, so both packages take the same branch for the same shapes. On a
card they are derived from the memory free at the call
(:meth:`ImplicitSequenceModel._serving_budgets`), the JAX package's values
as floors; a budget set on the model fixes it on every device. The plain
matmuls of serving run in full FP32 whatever the caller's
``torch.backends.cuda.matmul.allow_tf32``
(:func:`..utils.precision.fp32_matmul`); the flag is left as it was.
``approximate=True`` serves the exact list (its recall is 1). PyTorch runs
eagerly, so there is no program cache.

Under a mesh (``Hyperparameters.mesh``, :mod:`..parallel`) every rank runs
the model's methods together: ``fit`` splits each batch over the ``data``
axis and keeps the item table row-sharded over the ``model`` axis
(:mod:`.engine`); representations, ``predict``, the parameter views and
the evaluation read the whole table through sharded gathers, and every
rank returns the same values. ``recommend_batch`` runs as on one device
under a ``data``-only mesh. On a row-sharded table each rank takes the
exact top-k of its slab as a catalog of its own, by the route above that
fits the slab (:func:`topk_slab`), and one all-gather over ``model``
brings every slab's list to every rank, which merge them alike
(:func:`merge_topk_parts`); the users are not split over ``data``.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import itertools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import CompressedInteractions, extract_padded_windows, pack_streams, to_streams
from ..errors import InvalidPredictionValue, NoInteractions, NonFiniteLoss
from ..ops.topk_kernels import (
    groupmax_supported,
    phase1_error_bound,
    score_groupmax,
    score_groupmax_fp32,
    score_submax_groupmax,
    score_submax_groupmax_fp32,
    split_reps,
)
from ..ops.sampling import WARP_CANDIDATES
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, world
from ..parallel.sharding import batch_slice, gather_slabs, read_rows, slab_range
from ..utils import checkpoint
from ..utils.convert import params_from_numpy
from ..utils.metrics import FitHistory, logger, span
from ..utils.precision import fp32_matmul
from ..utils.tree import flatten, map_leaves
from . import ImplicitUser, Loss, Optimizer, Parallelism
from .engine import (
    EngineConfig,
    init_embedding_params,
    init_opt_state,
    make_train_step,
    table_biases,
    table_dtype,
    table_embeddings,
)


class Hyperparameters:
    """Fluent hyperparameters (reference ``src/models/lstm.rs:54-139``),
    with the JAX package's fields and defaults. ``mesh`` trains over a
    ``(data, model)`` mesh of ranks (:mod:`..parallel`); ``num_threads > 1``
    asks for a ``(data=n)`` mesh when a process group is initialised, and
    changes nothing in a single process, as in the JAX package on one
    device. ``parallelism`` changes nothing."""

    def __init__(self, num_items: int, max_sequence_length: int):
        self._num_items = int(num_items)
        self._max_sequence_length = int(max_sequence_length)
        self._item_embedding_dim = 16
        self._learning_rate = 0.01
        self._l2_penalty = 0.0
        self._loss = Loss.BPR
        self._optimizer = Optimizer.ADAM
        self._parallelism = Parallelism.SYNCHRONOUS
        self._num_threads = 1
        self._num_epochs = 10
        self._batch_size = 32
        self._seed = int(np.random.SeedSequence().entropy % (2**31))
        self._sparse_updates = None  # None = auto by table size
        self._packed = False
        self._table_dtype = "float32"
        self._lr_schedule = "constant"
        self._embedding_init_scale = 1.0
        self._mesh = None

    def learning_rate(self, learning_rate: float) -> "Hyperparameters":
        self._learning_rate = float(learning_rate)
        return self

    def lr_schedule(self, schedule: str) -> "Hyperparameters":
        if schedule not in ("constant", "linear", "cosine", "warmup_cosine"):
            raise ValueError(f"unknown lr schedule: {schedule!r}")
        self._lr_schedule = schedule
        return self

    def embedding_init_scale(self, scale: float) -> "Hyperparameters":
        self._embedding_init_scale = float(scale)
        return self

    def l2_penalty(self, l2_penalty: float) -> "Hyperparameters":
        self._l2_penalty = float(l2_penalty)
        return self

    def embedding_dim(self, embedding_dim: int) -> "Hyperparameters":
        self._item_embedding_dim = int(embedding_dim)
        return self

    def num_epochs(self, num_epochs: int) -> "Hyperparameters":
        self._num_epochs = int(num_epochs)
        return self

    def loss(self, loss: Loss) -> "Hyperparameters":
        self._loss = loss
        return self

    def optimizer(self, optimizer: Optimizer) -> "Hyperparameters":
        self._optimizer = optimizer
        return self

    def parallelism(self, parallelism: Parallelism) -> "Hyperparameters":
        self._parallelism = parallelism
        return self

    def num_threads(self, num_threads: int) -> "Hyperparameters":
        self._num_threads = int(num_threads)
        return self

    def batch_size(self, batch_size: int) -> "Hyperparameters":
        self._batch_size = int(batch_size)
        return self

    def from_seed(self, seed: int) -> "Hyperparameters":
        self._seed = int(seed) % (2**31)
        return self

    def rng(self, rng: "np.random.Generator | int") -> "Hyperparameters":
        """Seed from an RNG or integer (reference ``src/models/lstm.rs:122-125``)."""
        if isinstance(rng, np.random.Generator):
            self._seed = int(rng.integers(0, 2**31))
        else:
            self._seed = int(rng) % (2**31)
        return self

    def mesh(self, mesh) -> "Hyperparameters":
        """Train over a :class:`..parallel.Mesh` with axes ``("data",
        "model")``: batches split over ``data``, the item table and its
        optimizer state row-sharded over ``model``. Not written by
        ``to_dict``; ``clone`` keeps it."""
        self._mesh = mesh
        return self

    def sparse_updates(self, enabled: "bool | None") -> "Hyperparameters":
        self._sparse_updates = enabled
        return self

    def table_dtype(self, dtype: str) -> "Hyperparameters":
        """Storage dtype of the item table: ``"float32"`` or ``"bfloat16"``.
        Serving math is f32 either way."""
        table_dtype(dtype)  # validates
        self._table_dtype = str(dtype)
        return self

    def packed(self, enabled: bool) -> "Hyperparameters":
        self._packed = bool(enabled)
        return self

    # -- random search (reference ``src/models/lstm.rs:141-172``) ----------

    @classmethod
    def random(cls, num_items: int, rng: "np.random.Generator | int | None" = None) -> "Hyperparameters":
        """Random hyperparameters for search: the JAX package's draws, in
        its order (the families with knobs of their own draw them after)."""
        rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        return cls._random_common(num_items, rng)

    @classmethod
    def _random_common(cls, num_items: int, rng: np.random.Generator) -> "Hyperparameters":
        """The common draws of the JAX package's ``_random_common``.
        ``parallelism`` is not drawn (it changes nothing); ``num_threads`` is
        one ``integers`` call over the cards present, as the JAX package
        draws over its devices (it asks for a mesh only under an initialised
        process group). numpy draws nothing for a range of one value, so the
        later fields follow a JAX draw made over as many devices."""
        hp = cls(num_items, 2 ** int(rng.integers(4, 8)))
        hp._item_embedding_dim = 2 ** int(rng.integers(4, 8))
        hp._learning_rate = float(10.0 ** rng.uniform(-3.0, 0.5))
        hp._l2_penalty = float(10.0 ** rng.uniform(-7.0, -3.0))
        hp._loss = Loss.BPR if rng.random() < 0.5 else Loss.HINGE
        hp._optimizer = Optimizer.ADAM if rng.random() < 0.5 else Optimizer.ADAGRAD
        hp._num_threads = int(rng.integers(1, max(1, device_count()) + 1))
        hp._num_epochs = 2 ** int(rng.integers(3, 7))
        hp._batch_size = int(2 ** rng.integers(3, 8))
        hp._packed = bool(rng.random() < 0.5)
        hp._seed = int(rng.integers(0, 2**31))
        return hp

    def to_dict(self) -> dict:
        return {
            "num_items": self._num_items,
            "max_sequence_length": self._max_sequence_length,
            "item_embedding_dim": self._item_embedding_dim,
            "learning_rate": self._learning_rate,
            "l2_penalty": self._l2_penalty,
            "loss": self._loss.value,
            "optimizer": self._optimizer.value,
            "parallelism": self._parallelism.value,
            "num_threads": self._num_threads,
            "num_epochs": self._num_epochs,
            "batch_size": self._batch_size,
            "seed": self._seed,
            "packed": self._packed,
            "table_dtype": self._table_dtype,
            "sparse_updates": self._sparse_updates,
            "lr_schedule": self._lr_schedule,
            "embedding_init_scale": self._embedding_init_scale,
        }

    @classmethod
    def _from_dict_common(cls, d: dict) -> "Hyperparameters":
        """The common keys; a family's own keys are its ``from_dict``'s, and
        ``model_type`` and ``state_sha256`` are ignored."""
        hp = cls(d["num_items"], d["max_sequence_length"])
        hp._item_embedding_dim = d["item_embedding_dim"]
        hp._learning_rate = d["learning_rate"]
        hp._l2_penalty = d["l2_penalty"]
        hp._loss = Loss(d["loss"])
        hp._optimizer = Optimizer(d["optimizer"])
        hp._parallelism = Parallelism(d["parallelism"])
        hp._num_threads = d["num_threads"]
        hp._num_epochs = d["num_epochs"]
        hp._batch_size = d["batch_size"]
        hp._seed = d["seed"]
        hp._packed = d.get("packed", False)
        hp._table_dtype = d.get("table_dtype", "float32")
        hp._sparse_updates = d.get("sparse_updates")
        hp._lr_schedule = d.get("lr_schedule", "constant")
        hp._embedding_init_scale = d.get("embedding_init_scale", 1.0)
        return hp


def device_count() -> int:
    """The devices a model could run on: the CUDA cards, or 1 (the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# -- host-side request preparation (vectorised numpy) -------------------------


def _int64_array(shape) -> np.ndarray:
    return np.empty(shape, np.int64)


def _lengths(rows: Sequence[Sequence[int]]) -> np.ndarray:
    """Each row's length, as int64."""
    return np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))


def _flatten(histories: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """All histories' ids end to end, and each history's length."""
    lens = _lengths(histories)
    return _concat_rows(histories, lens), lens


def _concat_rows(rows: Sequence[Sequence[int]], lens: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``rows`` end to end as int64, ``lens`` their lengths: one
    ``np.concatenate`` where the rows are integer arrays (the first an
    array, the result 1-D, integer and ``lens.sum()`` long), else the
    rows' Python ints read one by one. ``out``: an int64 array of
    ``lens.sum()`` to write them into, and return."""
    if len(rows) and isinstance(rows[0], np.ndarray):
        if out is not None:
            try:  # the same rows as below, straight into ``out``
                return np.concatenate(rows, out=out)
            except (TypeError, ValueError):
                pass
        else:
            flat = np.concatenate(rows)
            if flat.ndim == 1 and flat.dtype.kind in "iu" and flat.size == lens.sum():
                return flat.astype(np.int64, copy=False)
    flat = np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64, count=int(lens.sum()))
    if out is None:
        return flat
    out[...] = flat
    return out


def _window_ids(flat: np.ndarray, lens: np.ndarray, t: int) -> np.ndarray:
    """The ids the tower reads: each history's last ``t`` (all of ``flat``
    when no history is longer)."""
    if not lens.size or lens.max() <= t:
        return flat
    rank = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
    return flat[rank >= np.repeat(lens - t, lens)]


def _tower_windows(
    flat: np.ndarray, times: Optional[np.ndarray], lens: np.ndarray, t: int, device, put=None
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The tower's inputs on ``device``: ``ids [U, t]``, ``times [U, t + 1]``
    (``None`` without ``times``) and ``last [U]``, gathered there from one
    copy of the flat rows (``flat``, ``times``: the histories end to end),
    with no host pass over ``U x t``. Row ``r`` holds history ``r``'s last
    ``keep = min(lens[r], t)`` ids left-aligned, then 0; its times likewise,
    then its last time to the end of the row, so column ``i + 1`` is
    position ``i``'s query time and the last valid position's is its own;
    ``last[r] = max(keep - 1, 0)``, the position whose state is the
    representation. An empty history reads as item 0 at time 0 (the
    reference's index inputs default to item 0). ``put(array)`` makes each
    host array's copy on ``device`` (:meth:`_SubBatch.put` in the pipelined
    small route); by default a plain copy."""
    if put is None:
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    u = len(lens)
    keep = np.minimum(lens, t)
    last = put(np.maximum(keep - 1, 0))
    if not flat.size:
        zeros = torch.zeros((u, t + 1), dtype=torch.int64, device=device)
        return zeros[:, :t], None if times is None else zeros, last
    meta = put(np.stack([np.where(keep > 0, np.cumsum(lens) - keep, 0), keep], axis=1))
    first, kept = meta[:, :1], meta[:, 1:]
    col = torch.arange(t + 1, device=device)
    src = first + torch.minimum(col, kept - 1).clamp_(min=0)
    ids = put(flat)[src[:, :t]].masked_fill_(col[:t] >= kept, 0)
    if times is None:
        return ids, None, last
    rows = put(times)[src].masked_fill_(kept == 0, 0)
    return ids, rows, last


def _check_times(timestamps: Sequence[Sequence[int]], lens: np.ndarray) -> None:
    """Raises ``ValueError`` unless each history (of ``lens`` items) has
    one timestamp an item."""
    if len(timestamps) != len(lens):
        raise ValueError(f"{len(timestamps)} rows of timestamps for {len(lens)} histories")
    bad = np.flatnonzero(_lengths(timestamps) != lens)
    if bad.size:
        r = int(bad[0])
        raise ValueError(f"history {r} has {lens[r]} items but {len(timestamps[r])} timestamps")


def _flatten_times(timestamps: Sequence[Sequence[int]], lens: np.ndarray) -> np.ndarray:
    """All histories' timestamps end to end (int64 seconds), as
    :func:`_flatten` lays out their ids; raises ``ValueError`` unless each
    history has one timestamp an item."""
    _check_times(timestamps, lens)
    return _concat_rows(timestamps, lens)


def _seen_rows(flat: np.ndarray, lens: np.ndarray, n: int, width: int, buffer=_int64_array) -> np.ndarray:
    """``[U, width]`` seen ids, each row's in history order then empty
    slots holding ``n`` (one past the catalog: never a candidate), in the
    int64 array ``buffer(shape)`` makes. The top-k reads them in any order;
    a caller that needs them sorted sorts them."""
    seen = buffer((len(lens), width))
    seen[...] = n
    seen[np.arange(width) < lens[:, None]] = flat
    return seen


def _seen(flat: np.ndarray, lens: np.ndarray, n: int, exclude_seen: bool, buffer=_int64_array) -> np.ndarray:
    """The rows the top-k filters: :func:`_seen_rows` with ``exclude_seen``,
    else one empty slot a user."""
    if exclude_seen:
        return _seen_rows(flat, lens, n, max(int(lens.max()), 1), buffer)
    seen = buffer((len(lens), 1))
    seen[...] = n
    return seen


# The small route serves a batch of at least twice this many users as
# ``U // PIPELINE_MIN_USERS`` sub-batches in a pipeline
# (:meth:`ImplicitSequenceModel.recommend_batch`): the host prepares
# one while the card runs the one before. From
# ``scripts/serve_pipeline_probe.py`` on an H100 (700 W) at the HSTU
# cell's 8,192 users, ms a batch (medians of 3 seeds) by sub-batches:
# 1: 86.6, 2: 75.4, 4: 73.6, 8: 93.2. At 4 the card is busy 89-90 % of
# the call; at 8 the host's fixed cost a sub-batch (its launches) outruns
# the card's ~9 ms of work, and the card waits (busy 63-72 %).
PIPELINE_MIN_USERS = 2048


class _SubBatch:
    """One sub-batch of ``recommend_batch`` on its way through the device
    (the whole batch where it is served in one): users ``[lo, hi)`` of the
    batch, the host arrays its copies read and write, and the event behind
    its lists' copies to the host. On a card the arrays are pinned and
    every copy is queued without a wait; they are held until the sub-batch
    lands, after the event, so that no buffer is reused under a copy (a
    call that raises waits for the card before it lets them go). On the
    CPU the same steps run on plain arrays."""

    def __init__(self, device: torch.device, lo: int, hi: int):
        self.device, self.lo, self.hi = device, lo, hi
        self.pinned = device.type == "cuda"
        self.held: List[torch.Tensor] = []
        self.out: Tuple[torch.Tensor, ...] = ()
        self.event = None

    def buffer(self, shape) -> np.ndarray:
        """An int64 host array (pinned on a card) to fill and :meth:`put`."""
        if not self.pinned:
            return _int64_array(shape)
        t = torch.empty(shape, dtype=torch.int64, pin_memory=True)
        self.held.append(t)
        return t.numpy()

    def put(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device. On a card a copy that does not wait, from
        ``a`` itself where it lies in pinned memory (:meth:`buffer`), else
        from a pinned copy of it."""
        h = torch.from_numpy(a)
        if not self.pinned:
            return h.to(self.device)
        if not h.is_pinned():
            h = h.pin_memory()
        self.held.append(h)
        return h.to(self.device, non_blocking=True)

    def fetch(self, tensors: Tuple[torch.Tensor, ...]) -> None:
        """Queue copies of ``tensors`` to the host (pinned buffers on a
        card), then an event behind them."""
        if not self.pinned:
            self.out = tensors
            return
        self.out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                         for t in tensors)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(self.device))

    def land(self, ids: np.ndarray, scores: Optional[np.ndarray]) -> None:
        """Wait for the copies (the sub-batch's one wait for the card),
        then write its ids into ``ids[lo:hi]`` and, where ``scores`` is
        given, its scores into ``scores[lo:hi]``."""
        if self.event is not None:
            self.event.synchronize()
        ids[self.lo : self.hi] = self.out[0].numpy()
        if scores is not None:
            scores[self.lo : self.hi] = self.out[1].numpy()
        self.held, self.out = [], ()


# -- exact top-k ---------------------------------------------------------------


def topk_small(
    table: torch.Tensor, reps: torch.Tensor, seen: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[U, N]`` scores, seen items set to ``-inf``, one top-k.
    Nothing here waits for the card."""
    with span("topk.small"):
        tab = table.to(torch.float32)
        n = tab.shape[0]
        with fp32_matmul():
            scores = reps @ tab[:, :-1].T + tab[:, -1]
        if seen.shape[1]:
            # One scatter, with no boolean index (whose nonzero waits for
            # the card). Padding slots (n) and any id outside the catalog
            # write -inf to the row's first seen id inside it, or, in a row
            # with none, column 0's own score back to it: every write to a
            # column writes the same value.
            inside = (seen >= 0) & (seen < n)
            first = torch.where(inside, seen, n).amin(dim=1, keepdim=True)
            some = first < n
            cols = torch.where(inside, seen, torch.where(some, first, 0))
            fill = torch.where(some, float("-inf"), scores[:, :1])
            scores.scatter_(1, cols, fill.expand_as(cols))
        return torch.topk(scores, min(k, n), dim=1)


# Groups of a super-group in :func:`_top_groups`' first level, and the
# fewest group maxima it selects from in two levels: below them one select
# down the columns takes less than the two levels' launches (on an H100 at
# 390,640 groups: 0.25 against 0.62 ms for 16 users, 0.62 against 0.40 ms
# for 32, 126.4 against 3.9 ms for 4,096).
SUPER_GROUP = 128
TWO_LEVEL_MIN_MAXIMA = 1 << 23


def _top_groups(gmax: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``w' = min(w, G)`` of the group maxima ``gmax [G, U]`` for
    each user, largest first: ``(vals [U, w'], ids [U, w'])``, what
    ``torch.topk(gmax, w', dim=0)`` gives, ties at the last value aside.

    That select runs down ``gmax``'s strided columns, many times slower
    than one read of it. With more than ``w`` whole super-groups of
    :data:`SUPER_GROUP` groups, and at least :data:`TWO_LEVEL_MIN_MAXIMA`
    maxima, it runs in two levels instead: the super-group maxima, one
    contiguous reduction over a view of ``gmax``; their top ``w`` a user;
    then the top ``w`` along each user's row of candidates: the groups
    those super-groups hold, and the tail's ``G % SUPER_GROUP`` groups
    beside them. A group among the top ``w`` is among the candidates: every
    super-group whose maximum beats its own holds a group that beats it,
    distinct super-groups hold distinct groups, and at most ``w - 1`` groups
    beat it, so its super-group is among the top ``w``. The candidates are
    distinct groups that hold the top ``w``, so the values are the same,
    the ``w``-th too."""
    g, u = gmax.shape
    w = min(w, g)
    blocks = g // SUPER_GROUP
    if blocks <= w or gmax.numel() < TWO_LEVEL_MIN_MAXIMA:
        vals, ids = torch.topk(gmax, w, dim=0)
        return vals.T, ids.T
    whole = blocks * SUPER_GROUP
    grouped = gmax[:whole].view(blocks, SUPER_GROUP, u)
    # Along rows: the transposing copy is small, and the select faster.
    _, si = torch.topk(grouped.amax(dim=1).T.contiguous(), w, dim=1)  # [U, w]
    users = torch.arange(u, device=gmax.device)[:, None]
    cand = grouped[si, :, users].reshape(u, w * SUPER_GROUP)  # [U, w, SUPER_GROUP] as rows
    vals, p = torch.topk(torch.cat([cand, gmax[whole:].T], dim=1), w, dim=1)
    held = torch.gather(si, 1, (p // SUPER_GROUP).clamp_(max=w - 1)) * SUPER_GROUP + p % SUPER_GROUP
    return vals, torch.where(p < w * SUPER_GROUP, held, p + (whole - w * SUPER_GROUP))


def _submax_winners(
    allsub: torch.Tensor, gmax: torch.Tensor, kk: int, r: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1's selection from the subgroup and group maxima ``[rows,
    U]``: the top ``kk`` groups (:func:`_top_groups`, in two levels on a
    large catalog), then among their ``r`` subgroups each the top ``kk``
    subgroups. Returns ``(sids [U, w], theta [U])``: the winning subgroup
    ids, and the largest maximum left out, ``max(the w1-th selected group
    maximum, the kk-th selected subgroup maximum)`` (each ``-inf`` where
    everything was selected), which bounds every score outside the
    winners."""
    u = allsub.shape[1]
    neg_inf = allsub.new_full((u,), float("-inf"))
    gv, gi = _top_groups(gmax, kk)  # [U, w1]
    w1 = gi.shape[1]
    theta_g = gv[:, -1] if w1 < gmax.shape[0] else neg_inf
    sids = (gi[:, :, None] * r + torch.arange(r, device=gi.device)).reshape(u, w1 * r)
    svals = torch.gather(allsub, 0, sids.T).T  # [U, w1 * r]
    w = min(kk, w1 * r)
    sv, sp = torch.topk(svals, w, dim=1)
    theta_s = sv[:, -1] if w < w1 * r else neg_inf
    return torch.gather(sids, 1, sp), torch.maximum(theta_g, theta_s)


def _group_winners(
    table: torch.Tensor,
    kk: int,
    u: int,
    score,
    *,
    serve_chunk: int,
    group: int,
    single_pass: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the group-only routes: ``score(rows, lo)`` gives the
    group maxima ``[groupmax_rows, U]`` of a slab of the table starting at
    row ``lo``. One call over the whole catalog (``single_pass``), or one per
    ``serve_chunk`` rows with a running merge, for ``u`` users; both keep
    ``kk + 1`` groups, selected by :func:`_top_groups`.
    Returns ``(gids [U, kk], theta [U])``: the top ``kk`` group ids, and the
    ``(kk+1)``-th maximum, the largest one left out (``-inf`` when every
    group was kept). In the merge a list's ``(kk+1)``-th value only rises,
    and it is at least the ``(kk+1)``-th of every chunk's candidates, so it
    ends as the catalog's. Unfilled merge slots hold distinct group ids past
    the catalog: never a real candidate. Each chunk is a view of the table;
    the last is shorter, and the kernel masks its rows past ``n``."""
    n = table.shape[0]
    if single_pass:
        with span("topk.phase1"):
            gmax = score(table, 0)
        vals, gids = _top_groups(gmax, kk + 1)
    else:
        groups_per_chunk = serve_chunk // group
        num_chunks = -(-n // serve_chunk)
        vals = torch.full((u, kk + 1), float("-inf"), device=table.device)
        past = num_chunks * groups_per_chunk
        gids = (past + torch.arange(kk + 1, device=table.device)).expand(u, kk + 1)
        for ch in range(num_chunks):
            lo = ch * serve_chunk
            with span("topk.phase1"):
                gm = score(table[lo : lo + serve_chunk], lo)[:groups_per_chunk]
            cv, cp = _top_groups(gm, kk + 1)
            mv = torch.cat([vals, cv], dim=1)
            mg = torch.cat([gids, ch * groups_per_chunk + cp], dim=1)
            vals, p = torch.topk(mv, kk + 1, dim=1)
            gids = torch.gather(mg, 1, p)
    theta = vals[:, kk] if vals.shape[1] > kk else vals.new_full((u,), float("-inf"))
    return gids[:, :kk], theta


def _rescore(
    table: torch.Tensor,
    reps_aug: torch.Tensor,
    seen: torch.Tensor,
    gids: torch.Tensor,
    width: int,
    k_out: int,
    phase2_buffer_bytes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: the items of the winning (sub)groups ``gids [U, w]`` of
    ``width`` rows each, scored in FP32 a few slots at a time so that the
    gathered rows stay under the budget; seen ids and ids past the catalog
    dropped; the top ``k_out`` values and their ids."""
    n, c_param = table.shape
    u, w = gids.shape
    slot_bs = _slot_batch(w, u, width, c_param, phase2_buffer_bytes)
    arange_w = torch.arange(width, device=table.device)
    cand_parts, score_parts = [], []
    for s0 in range(0, w, slot_bs):
        ids = (gids[:, s0 : s0 + slot_bs, None] * width + arange_w).reshape(u, -1)
        rows_g = table.index_select(0, ids.clamp(max=n - 1).reshape(-1))
        rows_g = rows_g.to(torch.float32).reshape(u, ids.shape[1], c_param)
        with fp32_matmul():
            score_parts.append(torch.bmm(rows_g, reps_aug[:, :, None])[:, :, 0])
        cand_parts.append(ids)
    cand = torch.cat(cand_parts, dim=1)
    cscores = torch.cat(score_parts, dim=1)
    cscores.masked_fill_(cand >= n, float("-inf"))
    # Drop seen candidates by id (broadcast compare against the seen rows).
    cscores.masked_fill_((cand[:, :, None] == seen[:, None, :]).any(dim=-1), float("-inf"))
    v, p = torch.topk(cscores, k_out, dim=1)
    return v, torch.gather(cand, 1, p)


# -- the streamed top-k's route and its memory budgets --------------------------

# The JAX package's budgets, sized for a 16 GB chip: serving's budgets on the
# CPU, and their floors on a card.
MERGE_BUFFER_FLOOR = 6 << 30
SUBMAX_BUFFER_FLOOR = 6 << 30
PHASE2_BUFFER_FLOOR = 1_200_000_000
# Share of a card's memory the derived budgets leave alone: the caching
# allocator's rounding, the kernels' scratch, phase 2's ids and other
# allocations of the batch.
BUDGET_MARGIN = 1 / 16


class StreamRoute(NamedTuple):
    """The route of :func:`topk_streamed`: ``single_pass`` (the whole
    catalog in one kernel call; else the running merge, chunk by chunk), the
    ``group`` width of phase 1's merge, the ``sub``group width of the
    single pass's refinement (``group``: group maxima only) and phase 2's
    ``slots``, the winning (sub)groups it gathers a step."""

    single_pass: bool
    group: int
    sub: int
    slots: int


def _group_width(serve_chunk: int, group_target: int) -> int:
    """The largest width <= ``group_target`` that divides the chunk."""
    group = min(group_target, serve_chunk)
    while serve_chunk % group:
        group -= 1
    return group


def _slot_batch(w: int, u: int, width: int, c_param: int, phase2_buffer_bytes: int) -> int:
    """Phase 2's slots a step, of ``w``: the gathered f32 rows ``[u, slots *
    width, c_param]`` within the budget, and at least one slot."""
    return max(1, min(w, phase2_buffer_bytes // (u * width * c_param * 4)))


def stream_route(
    n: int,
    c_param: int,
    u: int,
    kk: int,
    *,
    serve_chunk: int,
    group_target: int,
    sub_target: int,
    merge_buffer_bytes: int,
    submax_buffer_bytes: int,
    phase2_buffer_bytes: int,
) -> StreamRoute:
    """The route :func:`topk_streamed` takes for ``u`` users keeping ``kk``
    candidates a user over ``n`` rows of ``c_param`` columns. The single
    pass while twice its group-maxima stack fits the merge budget; its
    subgroup width the narrowest kernel width >= ``sub_target`` that
    divides the group and whose maxima stack fits the submax budget."""
    num_chunks = -(-n // serve_chunk)
    group = _group_width(serve_chunk, group_target)
    single_pass = num_chunks * (serve_chunk // group) * u * 8 <= merge_buffer_bytes
    sub = group
    if single_pass:
        for d in range(max(1, sub_target), group + 1):
            if group % d:
                continue
            if num_chunks * (serve_chunk // d) * u * 4 > submax_buffer_bytes:
                continue
            if not groupmax_supported(serve_chunk, c_param, u, d):
                continue
            sub = d
            break
    return StreamRoute(single_pass, group, sub, _slot_batch(kk, u, sub, c_param, phase2_buffer_bytes))


@functools.lru_cache(maxsize=None)
def _card_id(index: int) -> int:
    """An id of card ``index``, the same in every process that uses it:
    from its UUID, which never changes, so it is hashed once."""
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return int(hashlib.sha256(uuid.encode()).hexdigest()[:15], 16)


def card_reading(device: torch.device) -> Optional[Tuple[int, int, int, int]]:
    """``(card, free, cached, total)`` bytes of the card ``device``: an id
    of the card (:func:`_card_id`); the bytes free on the card
    (``torch.cuda.mem_get_info``); the bytes this process's caching
    allocator holds in segments it could release (reserved, less
    allocated, less the free pieces of segments still in use); the card's
    total. ``None`` for a device that is not a card."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    # The nested form: memory_stats() would flatten it in Python on every call.
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    cached = sum(
        sign * stats.get(key, {}).get("all", {}).get("current", 0)
        for sign, key in ((1, "reserved_bytes"), (-1, "allocated_bytes"), (-1, "inactive_split_bytes"))
    )
    card = _card_id(torch.cuda.current_device() if device.index is None else device.index)
    return card, int(free), max(0, int(cached)), int(total)


def budget_share(readings: Sequence[Tuple[int, int, int, int]]) -> int:
    """The bytes every rank may give a batch's serving buffers, from each
    rank's :func:`card_reading`: a card's free bytes less
    :data:`BUDGET_MARGIN` of its total, split evenly among the ranks that
    use it, plus the rank's own releasable cache; then the least over the
    ranks, so that ranks holding the same slab take the same route and
    serve the same bits."""
    on_card = collections.Counter(card for card, *_ in readings)
    shares = (
        (free - int(BUDGET_MARGIN * total)) // on_card[card] + cached for card, free, cached, total in readings
    )
    return max(0, min(shares))


def derive_budgets(avail: int, n: int, u: int, *, serve_chunk: int, group_target: int) -> Tuple[int, int, int]:
    """``(merge, submax, phase2)`` bytes from ``avail`` bytes free for a
    batch of ``u`` users over ``n`` rows, each at least its floor. The
    single pass allocates the group-maxima stack, and with the refinement
    the subgroup stack beside it: the merge budget is the whole of
    ``avail`` (the route takes it while twice the group stack fits, room for
    the stack and the top-k's work), the submax budget what the group stack
    leaves. Phase 2 runs once both are freed; its rows gathered in the
    table's dtype and their f32 copy may live together, so it takes half."""
    group = _group_width(serve_chunk, group_target)
    group_stack = -(-n // serve_chunk) * (serve_chunk // group) * u * 4
    return (
        max(MERGE_BUFFER_FLOOR, avail),
        max(SUBMAX_BUFFER_FLOOR, avail - group_stack),
        max(PHASE2_BUFFER_FLOOR, avail // 2),
    )


def topk_streamed(
    table: torch.Tensor,
    reps: torch.Tensor,
    seen: torch.Tensor,
    k: int,
    *,
    serve_chunk: int,
    group_target: int,
    sub_target: int,
    merge_buffer_bytes: int,
    submax_buffer_bytes: int,
    phase2_buffer_bytes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-phase top-k over a catalog larger than one chunk.

    Phase 1 keeps the top ``kk = k + S`` groups by group maximum: a group
    holding one of the true top-``kk`` items must rank there, because at
    most ``kk - 1`` items (hence groups) beat its maximum. With the
    single-pass merge the winners are refined one level down: among the
    winning groups' subgroups, the top ``kk`` by subgroup maximum (the same
    argument). On a large catalog the groups are found one level up, by the
    same argument again (:func:`_top_groups`): a top-``kk`` group's
    super-group of :data:`SUPER_GROUP` groups is among the top ``kk``
    super-groups by maximum, since each one that beats it holds a group
    that beats the group, and distinct super-groups hold distinct groups;
    so the top ``kk`` groups among the winning super-groups' are the same
    groups, and the largest maximum left out is the same value, ties at it
    aside. Phase 2 re-scores every candidate item in f32, drops seen ids
    and takes the top ``k``: at most ``S`` of the top ``kk`` are seen, so
    ``k`` survive. Equal scores exactly at the k-th value may pick other
    ids than a dense sort; values are exact.

    The single-pass refinement scores on the tensor cores in 3xTF32
    (:func:`..ops.topk_kernels.score_submax_groupmax`), whose scores lie
    within ``eps_u`` (:func:`..ops.topk_kernels.phase1_error_bound`, derived
    from the arithmetic) of the FP32 scores phase 2 computes. So every item
    left out of the candidates scores at most ``theta_u + eps_u`` in FP32
    (``theta_u``: the largest maximum left out, :func:`_submax_winners`),
    and a user whose k-th phase-2 value is at least that is exact, ties at
    the k-th value aside. The other users run phase 1 again in FP32
    (:func:`..ops.topk_kernels.score_submax_groupmax_fp32`) and phase 2, and
    their rows are replaced; ``topk_streamed.rechecked_users`` counts them.
    The ``group``-only single pass and the running merge score in 3xTF32 too
    (:func:`..ops.topk_kernels.score_groupmax`, the reps split once for all
    chunks) and keep ``kk + 1`` groups, whose last maximum is ``theta_u``
    (:func:`_group_winners`); they certify the same way and recheck with
    :func:`..ops.topk_kernels.score_groupmax_fp32`.

    ``topk_streamed.last_route`` holds the last call's route and its
    ``(merge, submax, phase2)`` budgets.
    """
    n, c_param = table.shape
    u = reps.shape[0]
    kk = min(k + seen.shape[1], n)
    k_out = min(k, n)
    with span("topk.route"):
        reps_aug = torch.cat([reps, reps.new_ones((u, 1))], dim=1).contiguous()
        route = stream_route(
            n, c_param, u, kk, serve_chunk=serve_chunk, group_target=group_target, sub_target=sub_target,
            merge_buffer_bytes=merge_buffer_bytes, submax_buffer_bytes=submax_buffer_bytes,
            phase2_buffer_bytes=phase2_buffer_bytes,
        )
        topk_streamed.last_route = (route, (merge_buffer_bytes, submax_buffer_bytes, phase2_buffer_bytes))
        single_pass, group, sub, _ = route
        if not groupmax_supported(serve_chunk, c_param, u, group):
            raise ValueError(
                f"the score+group-max kernel does not take group width {group} "
                f"(serve chunk {serve_chunk}, row width {c_param})"
            )
    r = group // sub

    def certify(vals, ids, theta, redo_fn):
        """Rows of the users the bound certifies stay; the others are
        replaced by ``redo_fn(users)``, their phase 1 in FP32."""
        with span("topk.certify"):
            eps = phase1_error_bound(table, reps_aug)
            bound = torch.nextafter(theta + eps, torch.full_like(theta, float("inf")))
            certified = torch.isneginf(theta) | (vals[:, -1] >= bound)
            redo = torch.nonzero(~certified).flatten()
            topk_streamed.rechecked_users += int(redo.numel())
            if redo.numel():
                with span("topk.recheck"):
                    vals[redo], ids[redo] = redo_fn(redo)
            return vals, ids

    if single_pass and r > 1:
        # One kernel call streams the whole table once; then the certificate.
        with span("topk.phase1"):
            allsub, gmax = score_submax_groupmax(table, reps_aug, 0, n, sub, group)
        with span("topk.winners"):
            sids, theta = _submax_winners(allsub, gmax, kk, r)
        del allsub, gmax
        with span("topk.phase2"):
            vals, ids = _rescore(table, reps_aug, seen, sids, sub, k_out, phase2_buffer_bytes)

        def redo_submax(redo):
            reps_r = reps_aug[redo].contiguous()
            with span("topk.phase1"):
                allsub, gmax = score_submax_groupmax_fp32(table, reps_r, 0, n, sub, group)
            with span("topk.winners"):
                sids, _ = _submax_winners(allsub, gmax, kk, r)
            del allsub, gmax
            with span("topk.phase2"):
                return _rescore(table, reps_r, seen[redo], sids, sub, k_out, phase2_buffer_bytes)

        return certify(vals, ids, theta, redo_submax)

    # Group maxima only (sub == group): the single pass or the running merge,
    # each K3 call under its own span (:func:`_group_winners`).
    winners = functools.partial(
        _group_winners, table, kk, serve_chunk=serve_chunk, group=group, single_pass=single_pass
    )
    with span("topk.phase1"):
        split = split_reps(reps_aug, table.dtype)  # once for every chunk call: K3's prologue
    with span("topk.winners"):
        gids, theta = winners(u, lambda rows, lo: score_groupmax(rows, reps_aug, lo, n, group, split=split))
    del split
    with span("topk.phase2"):
        vals, ids = _rescore(table, reps_aug, seen, gids, group, k_out, phase2_buffer_bytes)

    def redo_groups(redo):
        reps_r = reps_aug[redo].contiguous()
        with span("topk.winners"):
            gids, _ = winners(len(redo), lambda rows, lo: score_groupmax_fp32(rows, reps_r, lo, n, group))
        with span("topk.phase2"):
            return _rescore(table, reps_r, seen[redo], gids, group, k_out, phase2_buffer_bytes)

    return certify(vals, ids, theta, redo_groups)


topk_streamed.rechecked_users = 0
topk_streamed.last_route = None


def _slab_seen(seen: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Global seen rows ``[U, S]`` as the slab ``[lo, hi)``'s own: an id
    inside it becomes ``id - lo``; any other id, and the pad, ``hi - lo``
    (one past the slab). Each row is sorted ascending; the width ``S``
    stays the global one."""
    local = torch.where((seen >= lo) & (seen < hi), seen - lo, hi - lo)
    return local.sort(dim=1).values


def topk_slab(route, table: torch.Tensor, reps: torch.Tensor, seen: torch.Tensor, k: int, lo: int, num_items: int):
    """The slab step of the sharded top-k: ``table`` holds rows ``[lo, lo +
    n_loc)`` of a catalog of ``num_items``, ``seen [U, S]`` global ids (pad
    ``num_items``). ``route(table, reps, seen, k)`` takes the exact top-k of
    the slab as a catalog of its own (:meth:`ImplicitSequenceModel._catalog_topk`:
    its budgets and certificate apply to the slab). Returns ``(vals [U, k],
    ids [U, k])`` in global ids. Columns past the slab's own list (fewer than
    ``k`` rows, or a route's id past the slab, which the routes score
    ``-inf``) hold ``-inf`` and ids past the catalog, ``lo + num_items * (1
    + column)``: distinct over slabs and columns, and never a real item."""
    n_loc = table.shape[0]
    vals, local = route(table, reps, _slab_seen(seen, lo, lo + n_loc), min(k, n_loc))
    u = reps.shape[0]
    pad = lo + num_items * (1 + torch.arange(k, device=table.device)).expand(u, k)
    out_v = torch.full((u, k), float("-inf"), device=table.device)
    out_v[:, : vals.shape[1]] = vals
    ids = pad.clone()
    ids[:, : local.shape[1]] = torch.where(local < n_loc, local + lo, pad[:, : local.shape[1]])
    return out_v, ids


def merge_topk_parts(parts, k: int, num_items: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard merge: each slab's ``(vals [U, k], ids [U, k])``
    (:func:`topk_slab`), in the model axis's order, to the catalog's top
    ``k``. Exact: an item of the global top-k has at most ``k - 1`` unseen
    items above it in the whole catalog, so at most ``k - 1`` in its own
    slab, and it is in its slab's list (the slab's own exact top-k); the
    union holds the global top ``k``, and one selection over it finds them. Among equal values the
    padding ids (``>= num_items``) come last, then the parts' order, so the
    padding never displaces a real item (a slab's list may end in seen items
    at ``-inf``) and every rank picks the same ids. As on one rank, ties
    exactly at the k-th value may pick other ids than a dense sort; the
    values are exact."""
    vals = torch.cat([v for v, _ in parts], dim=1)
    ids = torch.cat([i for _, i in parts], dim=1)
    # Two stable sorts: by padding, then by value (descending).
    order = torch.sort((ids >= num_items).to(torch.int32), dim=1, stable=True).indices
    vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    top, p = torch.sort(vals, dim=1, descending=True, stable=True)
    return top[:, :k], torch.gather(ids, 1, p[:, :k])


def _interactions_fingerprint(interactions: CompressedInteractions) -> tuple:
    """A cheap content fingerprint of the arrays (the JAX package's): sums
    and an order-sensitive weighted hash catch in-place edits of the arrays
    behind an unchanged object."""
    ids = interactions.item_ids
    ptrs = interactions.user_pointers
    if len(ids):
        weights = np.arange(1, len(ids) + 1, dtype=np.uint64)
        id_hash = int((ids.astype(np.uint64) * weights).sum() % (2**61 - 1))
    else:
        id_hash = 0
    return (
        len(interactions),
        interactions.num_users,
        interactions.num_items,
        int(ids.sum()) if len(ids) else 0,
        id_hash,
        int(ptrs.sum()) if len(ptrs) else 0,
    )


class ImplicitSequenceModel:
    """Base class of the sequence models: ``fit``, user representations,
    ``predict`` and ``recommend_batch``. Subclasses provide the tower
    (``_init_tower``, ``_tower_fn``). All parameters live on ``device``,
    which the caller names; nothing runs anywhere else.

    Under a mesh every method is collective: every rank of the mesh calls
    it, with the same arguments (``fit``'s data, the histories, the test
    set, the checkpoint path), in the same order. The build too: every rank
    draws the whole table from the same seed, a chunk at a time, and keeps
    its slab (:func:`.engine.init_embedding_params`), so the initial
    parameters are the one-rank model's and no rank holds more than its
    slab and one chunk."""

    # Catalog chunk of the streamed top-k (the JAX package's value).
    _SERVE_ITEM_CHUNK = 131072
    # The tower reads each position's time (``timestamps`` in serving).
    _reads_times = False
    # ``fit`` without a mesh runs each batch as this many shares summed as
    # a data axis sums them (``engine.make_train_step(shares=...)``): the
    # collective-free reference a (2, m) mesh's fit is held to bit for bit.
    _data_shares = 1
    # Above this seen-list width, the k+S candidate post-filter stops paying.
    _SERVE_MAX_POSTFILTER_SEEN = 128
    # Serving's budgets in bytes (stream_route): None takes the device's
    # (_serving_budgets), a number fixes the budget on every device.
    # Single-pass phase-1 merge when 2x the group-maxima stack fits.
    _MERGE_BUFFER_BYTES: Optional[int] = None
    # Phase-2 rescoring: gathered f32 candidate rows per slot batch.
    _PHASE2_BUFFER_BYTES: Optional[int] = None
    # Phase-1 group width and the subgroup width of the refinement.
    _GROUP_TARGET = 128
    _SUBGROUP_TARGET = 32
    # Largest subgroup-maxima stack the refinement may allocate.
    _SUBMAX_BUFFER_BYTES: Optional[int] = None

    def __init__(
        self, hyper: Hyperparameters, device: "torch.device | str", item_table: Optional[torch.Tensor] = None
    ):
        """``item_table``: this rank's slab of a table to take as the
        model's, on ``device`` (a checkpoint's), instead of drawing one."""
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"cannot build a model on {device}: this PyTorch has no usable CUDA device"
                )
        elif device.type != "cpu":
            raise ValueError(f"models run on cuda or cpu, not {device}")
        if hyper._mesh is None and hyper._num_threads > 1:
            # num_threads is the reference's data-parallel degree
            # (src/models/sequence_model.rs:91-102): a (data=n) mesh over
            # the ranks present, as the JAX package makes one over its
            # devices; a single process has none.
            size, _ = world()
            n = min(hyper._num_threads, size)
            if n > 1:
                if n != size:
                    raise ValueError(
                        f"num_threads={hyper._num_threads} asks for a mesh of {n} of the "
                        f"{size} ranks; a mesh spans the whole process group"
                    )
                hyper._mesh = make_mesh(data=n, model=1)
        self.hyper = hyper
        self.device = device
        gen = torch.Generator(device=device).manual_seed(hyper._seed)
        rows = slab_range(hyper._mesh, hyper._num_items)  # raises on an empty slab
        if item_table is None:
            params = init_embedding_params(
                gen, hyper._num_items, hyper._item_embedding_dim, device,
                dtype=hyper._table_dtype, init_scale=hyper._embedding_init_scale, rows=rows,
            )
        else:
            want = (rows[1] - rows[0], hyper._item_embedding_dim + 1)
            if tuple(item_table.shape) != want:
                raise ValueError(f"item_table slab {tuple(item_table.shape)} does not match {want}")
            params = {"item_table": item_table.to(device, table_dtype(hyper._table_dtype))}
        params["tower"] = self._init_tower(gen, hyper._item_embedding_dim)
        self._params = params
        # Training randomness continues from the parameter draws.
        self._train_generator = gen
        # The tower's train-time dropout masks: a stream of their own, from
        # the seed (as the JAX step folds the tower's key out of the step key).
        dropout_seed = int(np.random.SeedSequence([hyper._seed, 1]).generate_state(1)[0])
        self._dropout_generator = torch.Generator(device=device).manual_seed(dropout_seed)
        # The JAX PRNG key a checkpoint records (see ..utils.checkpoint).
        self._jax_key = checkpoint.fresh_key(hyper._seed)
        self._window_cache = None
        self.history: Optional[FitHistory] = None

    # -- subclass hooks -------------------------------------------------------

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        raise NotImplementedError

    def _tower_fn(self):
        """``(tower_params, x [B, T, D], starts=None) -> hidden [B, T, D]``,
        differentiable; ``starts [B, T]`` marks packed-window starts. A
        tower with train-time randomness also takes ``generator=`` (None:
        deterministic, as serving and evaluation call it)."""
        raise NotImplementedError

    # -- training -------------------------------------------------------------

    def _engine_config(self) -> EngineConfig:
        hp = self.hyper
        sparse = hp._sparse_updates
        if sparse is None:
            # Auto: dense full-table updates while the table streams
            # cheaply; beyond that, touched rows only.
            sparse = hp._num_items * max(hp._item_embedding_dim, 1) > (1 << 22)
        if hp._mesh is not None and hp._mesh.model > 1:
            sparse = True  # a row-sharded table takes the touched-rows update
        return EngineConfig(
            num_items=hp._num_items,
            loss=hp._loss,
            optimizer=hp._optimizer,
            learning_rate=hp._learning_rate,
            l2_penalty=hp._l2_penalty,
            sparse_updates=sparse,
            lr_schedule=hp._lr_schedule,
        )

    def _epoch_permutation(self, epoch: int, n: int) -> torch.Tensor:
        """The order of the ``n`` windows in epoch ``epoch`` (int64, on the
        device), drawn from the training generator."""
        return torch.randperm(n, generator=self._train_generator, device=self.device)

    def _step_candidates(self, step: int, shape: Tuple[int, int, int]) -> torch.Tensor:
        """Uniform negative candidates ``[B, T, K]`` (int64, on the device)
        for step ``step`` of the fit, drawn from the training generator."""
        return torch.randint(
            0, self.hyper._num_items, shape, generator=self._train_generator, device=self.device
        )

    def _windows(self, interactions: CompressedInteractions):
        """``(stream, mask, starts, n, num_examples)`` on the device, each
        with a zero-mask sentinel row at index ``n``; cached per
        interactions object (and content fingerprint), sequence length and
        packing."""
        hp = self.hyper
        t_len = hp._max_sequence_length
        key = (id(interactions), _interactions_fingerprint(interactions), t_len, hp._packed)
        if self._window_cache is not None and self._window_cache[0] == key:
            return self._window_cache[2]
        padded = extract_padded_windows(interactions, t_len)
        if len(padded) == 0:
            raise NoInteractions()
        windows = pack_streams(padded, t_len) if hp._packed else to_streams(padded)

        def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            a = np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])
            return torch.from_numpy(a).to(device=self.device, dtype=dtype)

        stream = put(windows.stream, torch.int64)
        mask = put(windows.mask, torch.float32)
        starts = None if windows.starts is None else put(windows.starts, torch.float32)
        out = (stream, mask, starts, len(windows), windows.num_examples)
        # The cache holds the object, so the id in its key stays valid.
        self._window_cache = (key, interactions, out)
        return out

    def fit(self, interactions: CompressedInteractions) -> float:
        """Fit the model, returning the mean loss ``loss_sum / (1 +
        examples)`` (reference ``src/models/sequence_model.rs:173-175``).

        Windows longer than two items are cut from each user's history
        (first chunk smallest), laid out one per row or packed, and walked
        in ``ceil(n / batch_size)`` minibatches per epoch in a fresh random
        order; the last batch is filled with the zero-mask sentinel row.
        Under a mesh the batch is rounded up to a multiple of ``data`` (the
        extra rows read the sentinel window); every rank draws the global
        permutation and candidates from the same generator and takes its
        share (:func:`..parallel.sharding.batch_slice`), so the sharded fit
        sees the one-rank fit's draws, and the epoch losses are summed over
        the data group.
        Repeated calls continue from the current parameters with a fresh
        optimizer state, as the reference rebuilds its optimizer per fit
        (``src/models/sequence_model.rs:90``). Raises
        :class:`NoInteractions` when no window survives and
        :class:`NonFiniteLoss` when the loss sum is not finite.
        """
        hp = self.hyper
        mesh = hp._mesh
        stream, mask, starts, n, num_examples = self._windows(interactions)
        t_len = hp._max_sequence_length
        batch_size = min(hp._batch_size, n)
        split = mesh.data if mesh is not None else self._data_shares
        batch_size = -(-batch_size // split) * split
        num_batches = -(-n // batch_size)  # ceil: no window is dropped
        n_pad = num_batches * batch_size
        epochs = hp._num_epochs
        train_step = make_train_step(
            self._engine_config(), self._tower_fn(), total_steps=num_batches * epochs,
            generator=self._dropout_generator, mesh=mesh, shares=self._data_shares,
        )
        share = batch_slice(mesh, batch_size)
        k_cand = WARP_CANDIDATES if hp._loss == Loss.WARP else 1
        params = self._params
        opt_state = init_opt_state(hp._optimizer, params)
        losses = []
        t0 = time.perf_counter()
        for epoch in range(epochs):
            perm = self._epoch_permutation(epoch, n)
            if n_pad > n:  # padding rows read the sentinel window
                perm = torch.cat([perm, perm.new_full((n_pad - n,), n)])
            for i in range(num_batches):
                rows = perm[i * batch_size : (i + 1) * batch_size][share]
                batch = {"stream": stream[rows], "mask": mask[rows]}
                if starts is not None:
                    batch["starts"] = starts[rows]
                candidates = self._step_candidates(
                    epoch * num_batches + i, (batch_size, t_len, k_cand)
                )[share]
                params, opt_state, loss = train_step(params, opt_state, batch, candidates)
                losses.append(loss)
        if losses:  # the one host sync of the fit
            step_losses = torch.stack(losses)
            if mesh is not None:
                mesh.all_reduce(step_losses, DATA_AXIS)
            epoch_losses = step_losses.reshape(epochs, num_batches).sum(dim=1).cpu().numpy()
        else:
            epoch_losses = np.zeros((0,), np.float32)
        wall_s = time.perf_counter() - t0

        self._params = params
        self.history = FitHistory(
            epoch_losses=epoch_losses,
            examples_per_epoch=num_examples,
            num_epochs=epochs,
            wall_s=wall_s,
        )
        logger.info(self.history.summary())
        total_loss = float(epoch_losses.sum())
        if not np.isfinite(total_loss):
            raise NonFiniteLoss(f"Training diverged: epoch losses {epoch_losses.tolist()}")
        return total_loss / (1.0 + num_examples * epochs)

    # -- parameters -----------------------------------------------------------

    def _full_table(self) -> torch.Tensor:
        """The whole item table (the slabs gathered under a model axis)."""
        return gather_slabs(self._params["item_table"], self.hyper._mesh, self.hyper._num_items)

    @property
    def item_embeddings(self) -> np.ndarray:
        """Item embedding matrix ``[num_items, dim]`` (f32 copy; every rank
        gets the whole table)."""
        return table_embeddings({"item_table": self._full_table()}).to(torch.float32).cpu().numpy()

    @property
    def item_biases(self) -> np.ndarray:
        """Item bias vector ``[num_items]`` (f32 copy; every rank gets the
        whole table)."""
        return table_biases({"item_table": self._full_table()}).to(torch.float32).cpu().numpy()

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        """f32 rows ``[M, D + 1]`` of the whole table for in-range ids ``[M]``."""
        return read_rows(self._params["item_table"], ids, self.hyper._mesh, self.hyper._num_items)

    def load_numpy_params(self, tree: dict) -> None:
        """Load parameters given as numpy arrays in the JAX package's tree
        (``{"item_table": [N, D+1], "tower": {...}}``, the tower nested as
        the family's) onto this model's device, as :meth:`load_params`."""
        self.load_params(params_from_numpy(tree, self.device))

    def load_params(self, tree: dict) -> None:
        """Load a parameter tree of tensors (on any device) in the JAX
        package's layout. Paths and shapes must match the model's (the whole
        table's; under a model axis the rank keeps its slab); the table
        keeps the model's storage dtype, the tower is f32, and tensors
        already on this device in those dtypes are taken without a copy."""
        want = (self.hyper._num_items, self.hyper._item_embedding_dim + 1)
        if tuple(tree["item_table"].shape) != want:
            raise ValueError(f"item_table {tuple(tree['item_table'].shape)} does not match {want}")
        lo, hi = slab_range(self.hyper._mesh, want[0])
        table = tree["item_table"]
        if (lo, hi) != (0, want[0]):  # a copy of the slab: the whole table may be freed
            table = table[lo:hi].to(self.device, copy=True)
        self._install_params(table, tree["tower"])

    def _install_params(self, table: torch.Tensor, tower) -> None:
        """Take ``table`` (this rank's slab) and ``tower`` (its paths and
        shapes checked against the model's) as the model's parameters."""
        new = {
            "item_table": table.to(self.device),
            "tower": map_leaves(lambda v: v.to(self.device), tower),
        }
        if tuple(new["item_table"].shape) != tuple(self._params["item_table"].shape):
            raise ValueError(
                f"item_table slab {tuple(new['item_table'].shape)} does not match "
                f"{tuple(self._params['item_table'].shape)}"
            )
        shapes = [(path, tuple(v.shape)) for path, v in flatten(new["tower"])]
        if shapes != [(path, tuple(v.shape)) for path, v in flatten(self._params["tower"])]:
            raise ValueError("tower parameters do not match this model's")
        new["item_table"] = new["item_table"].to(self._params["item_table"].dtype)
        new["tower"] = map_leaves(lambda v: v.to(torch.float32), new["tower"])
        self._params = new

    # -- serving --------------------------------------------------------------

    def _representations(
        self, flat: np.ndarray, lens: np.ndarray, timestamps: Optional[np.ndarray] = None, put=None
    ) -> torch.Tensor:
        """Batched user representations ``[U, D]`` (f32, on the device) of
        the histories given as :func:`_flatten` output (reference
        ``src/models/sequence_model.rs:182-211``): the tower over each
        history's last ``max_sequence_length`` items, final state.
        ``timestamps``: the items' times as :func:`_flatten_times` gives
        them, which a family whose tower reads times (``_reads_times``)
        needs and any other refuses (``ValueError``). Only the ids the
        windows read are checked, on the host; the windows are laid out on
        the device (:func:`_tower_windows`, each host array copied by
        ``put``), and nothing here waits for the tower."""
        if self._reads_times and timestamps is None:
            raise ValueError(f"{type(self).__name__} needs the histories' timestamps")
        if not self._reads_times and timestamps is not None:
            raise ValueError(f"{type(self).__name__} reads no timestamps; pass none")
        t = self.hyper._max_sequence_length
        n = self.hyper._num_items
        u = len(lens)
        with span("tower.inputs"):
            window = _window_ids(flat, lens, t)
            if window.size and (window.min() < 0 or window.max() >= n):
                raise InvalidPredictionValue(f"History contains item ids outside [0, {n}).")
            ids, times, last = _tower_windows(flat, timestamps, lens, t, self.device, put)
        emb = self._rows(ids.reshape(-1))[:, :-1]
        args = (times, last + 1) if self._reads_times else ()
        with fp32_matmul():
            hidden = self._tower_fn()(self._params["tower"], emb.reshape(u, t, -1), *args)
        return hidden[torch.arange(u, device=self.device), last]

    def user_representation(
        self, item_ids: Sequence[int], timestamps: Optional[Sequence[int]] = None
    ) -> ImplicitUser:
        """User representation from an interaction history (``src/lib.rs:105-108``);
        ``timestamps``: the items' times, for a family that reads them."""
        return self.user_representations([item_ids], None if timestamps is None else [timestamps])[0]

    def user_representations(
        self, histories: Sequence[Sequence[int]], timestamps: Optional[Sequence[Sequence[int]]] = None
    ) -> List[ImplicitUser]:
        """Batched :meth:`user_representation`: one tower run for all users."""
        flat, lens = _flatten(histories)
        times = None if timestamps is None else _flatten_times(timestamps, lens)
        reps = self._representations(flat, lens, times).cpu().numpy()
        return [ImplicitUser(user_embedding=r) for r in reps]

    def recommend(
        self,
        item_ids: Sequence[int],
        k: int = 10,
        exclude_seen: bool = True,
        timestamps: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Top-``k`` next items for one history (see :meth:`recommend_batch`)."""
        times = None if timestamps is None else [timestamps]
        return self.recommend_batch([item_ids], k=k, exclude_seen=exclude_seen, timestamps=times)[0]

    def recommend_batch(
        self,
        histories: Sequence[Sequence[int]],
        k: int = 10,
        exclude_seen: bool = True,
        approximate: bool = False,
        recall_target: float = 0.95,
        return_scores: bool = False,
        timestamps: Optional[Sequence[Sequence[int]]] = None,
    ):
        """Exact top-``k`` next items for many histories: representations,
        full-catalog scoring, seen-item exclusion (with ``exclude_seen``)
        and the top-k, all on the device. ``return_scores=True`` also
        returns the items' scores ``dot(user, emb) + bias`` as ``[U, k]``.
        On a table row-sharded over the mesh's ``model`` axis every rank
        serves the whole batch: the top-k of its slab, then one all-gather
        of the slabs' lists over ``model`` and the same merge on every rank
        (:func:`topk_slab`, :func:`merge_topk_parts`), so every rank returns
        the same ids and scores.

        The batch runs as :meth:`_pipeline_parts` sub-batches of consecutive
        users (one but on the small route at ``2 * PIPELINE_MIN_USERS``
        users or more), each through the same stages (prepare, tower, seen
        rows, top-k, lists to the host), with the host one sub-batch ahead
        of the card: it prepares and queues sub-batch ``j + 1``, its copies
        pinned and queued without a wait (:class:`_SubBatch`), before it
        waits for sub-batch ``j``'s lists. A user's list and scores do not
        depend on the other users of its batch, so they are the same in any
        number of sub-batches; an id outside the catalog in any of them
        raises before the call returns.

        ``approximate`` and ``recall_target`` are the JAX package's
        arguments for its ``lax.approx_max_k`` mode, a TPU operation that
        guarantees a recall of at least ``recall_target``. Here both modes
        serve the exact list, whose recall is 1, so it meets every target;
        with ``approximate=True``, ``recall_target`` must lie in (0, 1], as
        the JAX package's mode requires.

        ``timestamps``: one row a history, one int time in seconds an item,
        for a family whose tower reads times (HSTU); ``ValueError`` when a
        row's length differs from its history's, when such a family gets
        none, or when another family gets some."""
        if approximate and not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        if not len(histories):
            return ([], np.zeros((0, k), np.float32)) if return_scores else []
        u, n = len(histories), self.hyper._num_items
        parts = self._pipeline_parts(u)
        cuts = [u * j // parts for j in range(parts + 1)]
        ids = np.empty((u, min(k, n)), np.int64)
        scores = np.empty((u, min(k, n)), np.float32) if return_scores else None
        lists: List[List[int]] = []
        ahead = None  # the sub-batch on the card while the host prepares the next
        with span("recommend_batch"):
            try:
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    sub = _SubBatch(self.device, lo, hi)
                    with span("serve.prepare"):
                        if not lo:  # the whole batch's lengths, and its timestamps' counts
                            lens = _lengths(histories)
                            if timestamps is not None:
                                _check_times(timestamps, lens)
                        sub_lens = lens[lo:hi]
                        flat = _concat_rows(histories[lo:hi], sub_lens, sub.buffer(int(sub_lens.sum())))
                        times = None
                        if timestamps is not None:
                            times = _concat_rows(timestamps[lo:hi], sub_lens, sub.buffer(flat.size))
                    if not lo:
                        # Once a batch, before the tower is queued: the reading waits for no kernel.
                        with span("serve.budgets"):
                            budgets = self._serving_budgets(u, max(int(lens.max()), 1) if exclude_seen else 1)
                    with span("serve.tower"):
                        reps = self._representations(flat, sub_lens, times, sub.put)
                    # The seen rows are laid out while the tower runs.
                    with span("serve.prepare"):
                        seen = _seen(flat, sub_lens, n, exclude_seen, sub.buffer)
                    with span("serve.topk"):
                        vals, idx = self._topk(reps, sub.put(seen), min(k, n), budgets)
                        sub.fetch((idx, vals) if return_scores else (idx,))
                    # The lists become Python lists in two ``tolist`` calls, all
                    # but the last sub-batch's while the card runs the last: each
                    # call can start a collection of the garbage collector's
                    # youngest generation, and so of the older ones, long where
                    # the caller holds many results.
                    if ahead is not None:
                        with span("serve.to_host"):
                            ahead.land(ids, scores)
                            if hi == u:  # the last sub-batch is queued
                                lists = ids[:lo].tolist()
                    ahead = sub
                with span("serve.to_host"):
                    ahead.land(ids, scores)
                    lists += ids[ahead.lo :].tolist()
            except BaseException:
                if self.device.type == "cuda":  # no pinned buffer is let go under a queued copy
                    torch.cuda.current_stream(self.device).synchronize()
                raise
        if parts > 1:
            ImplicitSequenceModel.recommend_batch.pipelined_subbatches += parts
        return (lists, scores) if return_scores else lists

    def _pipeline_parts(self, u: int) -> int:
        """The sub-batches a batch of ``u`` users is served in: ``u //
        PIPELINE_MIN_USERS`` on the small route of a table no ``model``
        axis splits (no collective in the loop), else 1. The small route
        takes any seen width, so the catalog's rows pick it here."""
        mesh = self.hyper._mesh
        if u < 2 * PIPELINE_MIN_USERS or (mesh is not None and mesh.model > 1):
            return 1
        if self._catalog_route(self.hyper._num_items, 1) != "small":
            return 1
        return u // PIPELINE_MIN_USERS

    def _topk(self, reps: torch.Tensor, seen: torch.Tensor, k: int, budgets: Tuple[int, int, int]):
        """The exact top-``k`` of the whole catalog on the ``budgets``
        (:meth:`_serving_budgets`): the table's own route, or on a
        row-sharded table the slab's, then the cross-shard merge. The
        slab's list travels in one all-gather (values as their int32 bits
        beside the ids, in one int64 tensor)."""
        table = self._params["item_table"]
        mesh = self.hyper._mesh
        route = functools.partial(self._catalog_topk, budgets=budgets)
        if mesh is None or mesh.model == 1:
            return route(table, reps, seen, k)
        n = self.hyper._num_items
        lo, _ = slab_range(mesh, n)
        vals, ids = topk_slab(route, table, reps, seen, k, lo, n)
        with span("topk.merge"):
            packed = torch.cat([vals.view(torch.int32).to(torch.int64), ids], dim=1)
            parts = [
                (p[:, :k].to(torch.int32).view(torch.float32), p[:, k:]) for p in mesh.all_gather(packed, MODEL_AXIS)
            ]
            return merge_topk_parts(parts, k, n)

    def _serving_budgets(self, u: int, seen_width: int) -> Tuple[int, int, int]:
        """``(merge, submax, phase2)`` bytes for a batch of ``u`` users with
        seen lists ``seen_width`` wide (:func:`topk_streamed`). A budget set
        on the model (``_MERGE_BUFFER_BYTES``, ``_SUBMAX_BUFFER_BYTES``,
        ``_PHASE2_BUFFER_BYTES`` not ``None``) is taken as it is. The others
        are the floors on the CPU (the JAX package's values), and on a card
        :func:`derive_budgets` of the bytes free at the call
        (:func:`card_reading`, :func:`budget_share`) for the largest slab.
        Under a mesh the ranks' readings travel in one all-gather (on the
        host over gloo), so every rank takes the same budgets. The card is
        read only for a batch the streamed route serves
        (:meth:`_catalog_route` of the largest slab): the same on every
        rank, so every rank joins the collective or none does."""
        fixed = (self._MERGE_BUFFER_BYTES, self._SUBMAX_BUFFER_BYTES, self._PHASE2_BUFFER_BYTES)
        budgets = (MERGE_BUFFER_FLOOR, SUBMAX_BUFFER_FLOOR, PHASE2_BUFFER_FLOOR)
        mesh = self.hyper._mesh
        rows = -(-self.hyper._num_items // (1 if mesh is None else mesh.model))
        streamed = self._catalog_route(rows, seen_width) == "streamed"
        reading = card_reading(self.device) if streamed and None in fixed else None
        if reading is not None:
            readings = [reading]
            if mesh is not None:
                on = self.device if mesh.backend == "nccl" else "cpu"
                mine = torch.tensor(reading, dtype=torch.int64, device=on)
                readings = [tuple(p.tolist()) for p in mesh.all_gather(mine, None)]
            budgets = derive_budgets(
                budget_share(readings), rows, u, serve_chunk=self._SERVE_ITEM_CHUNK, group_target=self._GROUP_TARGET
            )
        return tuple(b if f is None else f for f, b in zip(fixed, budgets))

    def _catalog_route(self, rows: int, seen_width: int) -> str:
        """The route of a catalog of ``rows`` rows for seen lists
        ``seen_width`` wide: ``"small"`` (:func:`topk_small`),
        ``"wide_seen"`` (:func:`topk_slab` a chunk, :func:`merge_topk_parts`)
        or ``"streamed"`` (:func:`topk_streamed`, the one that reads the
        budgets)."""
        if rows <= self._SERVE_ITEM_CHUNK:
            return "small"
        if seen_width > self._SERVE_MAX_POSTFILTER_SEEN:
            return "wide_seen"
        return "streamed"

    def _catalog_topk(
        self, table: torch.Tensor, reps: torch.Tensor, seen: torch.Tensor, k: int, budgets: Tuple[int, int, int]
    ):
        """The exact top-``k`` of ``table`` as a whole catalog (seen ids
        past it never match), by the route its size and the seen width pick
        (:meth:`_catalog_route`) on the ``(merge, submax, phase2)`` budgets
        (:meth:`_serving_budgets`). Wide seen lists are served as a
        row-sharded table is, on one rank, in slabs of one chunk."""
        n = table.shape[0]
        serve_chunk = self._SERVE_ITEM_CHUNK
        route = self._catalog_route(n, seen.shape[1])
        if route == "small":
            return topk_small(table, reps, seen, k)
        if route == "wide_seen":
            parts = [
                topk_slab(topk_small, table[lo : lo + serve_chunk], reps, seen, k, lo, n)
                for lo in range(0, n, serve_chunk)
            ]
            with span("topk.merge"):
                return merge_topk_parts(parts, k, n)
        merge, submax, phase2 = budgets
        return topk_streamed(
            table, reps, seen, k,
            serve_chunk=serve_chunk,
            group_target=self._GROUP_TARGET,
            sub_target=self._SUBGROUP_TARGET,
            merge_buffer_bytes=merge,
            submax_buffer_bytes=submax,
            phase2_buffer_bytes=phase2,
        )

    def predict(self, user: ImplicitUser, item_ids: "Sequence[int] | None" = None) -> np.ndarray:
        """Score ``item_ids`` for the user: ``dot(user, emb) + bias``
        (``src/models/lstm.rs:338-350``); ``None`` scores the whole catalog.
        Raises :class:`InvalidPredictionValue` on ids outside the catalog and
        on non-finite scores (``src/models/sequence_model.rs:222-230``)."""
        n = self.hyper._num_items
        ids = np.arange(n) if item_ids is None else np.asarray(item_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise InvalidPredictionValue(f"item_ids outside [0, {n}).")
        rows = self._rows(torch.from_numpy(ids.reshape(-1)).to(self.device))
        rep = torch.as_tensor(
            np.asarray(user.user_embedding, dtype=np.float32), device=self.device
        )
        with fp32_matmul():
            scores = (rows[:, :-1] @ rep + rows[:, -1]).cpu().numpy()
        if not np.all(np.isfinite(scores)):
            raise InvalidPredictionValue()
        return scores

    def clone(self) -> "ImplicitSequenceModel":
        """Independent copy on the same device: hyperparameters and the mesh,
        parameters (deep-copied; under a mesh, this rank's slab), the states
        of the training and dropout generators, so the copy's next ``fit``
        draws what this model's next ``fit`` would, and the JAX key a
        checkpoint records. Collective under a mesh."""
        hyper = type(self.hyper).from_dict(self.hyper.to_dict()).mesh(self.hyper._mesh)
        m = hyper.build(self.device)
        m._params = {
            "item_table": self._params["item_table"].clone(),
            "tower": map_leaves(torch.clone, self._params["tower"]),
        }
        m._train_generator.set_state(self._train_generator.get_state())
        m._dropout_generator.set_state(self._dropout_generator.get_state())
        m._jax_key = self._jax_key.copy()
        return m

    # -- checkpointing ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Save to the directory ``path`` in the JAX package's checkpoint
        format (:mod:`..utils.checkpoint`; under a mesh the primary rank
        writes the whole table)."""
        checkpoint.save_model(self, path)

    @classmethod
    def load(cls, path: str, device: "torch.device | str" = "cuda", mesh=None) -> "ImplicitSequenceModel":
        """The model saved at ``path`` by either package, on ``device`` (the
        card unless the caller asks for ``"cpu"``; without CUDA a ``cuda``
        load raises), over ``mesh`` when given (each rank reads its slab,
        whatever mesh saved it)."""
        return checkpoint.load_model(path, device, mesh=mesh)


# Sub-batches the pipelined small route has served, in calls of more than
# one (:meth:`ImplicitSequenceModel._pipeline_parts`).
ImplicitSequenceModel.recommend_batch.pipelined_subbatches = 0
