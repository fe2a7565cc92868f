"""Host-side data containers and splits.

A copy of :mod:`sbr_rs_tpu.data` (importing that module would load jax):
numpy only, the same arrays for the same inputs, so either package's
windows feed the other's training step. Original note:

TPU-native re-design of the reference's data layer (``src/data.rs``). The
reference stores interactions as a ``Vec<Interaction>`` of structs and walks
them one element at a time; here everything is columnar ``numpy`` from the
start so that window extraction produces padded ``[N, T]`` device-ready
batches instead of per-timestep graph feeds.

Behavioral contract preserved from the reference:

* ``Interactions`` — (user, item, timestamp) event container with
  ``num_users``/``num_items`` shape, shuffle / split_at / split_by
  (``src/data.rs:91-211``). ``weight()`` is hard-coded 1.0 (implicit
  feedback, ``src/data.rs:44-46``).
* ``train_test_split`` — shuffle then fraction split, *test fraction is the
  head* (``src/data.rs:53-64``).
* ``user_based_split`` — disjoint user sets via keyed SipHash-2-4 of the
  user id mod 100_000 against a cutoff, hash keys drawn from the caller's
  RNG (``src/data.rs:69-88``).
* ``CompressedInteractions`` — CSR-by-user, rows sorted stably by
  (user_id, timestamp) (``src/data.rs:213-329``).
* Chunking — a user's history is cut into windows where the *first* chunk is
  smallest and the rest are exactly ``chunk_size`` (``src/data.rs:406-432``);
  training keeps only windows of length > 2
  (``src/models/sequence_model.rs:76-83``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Interaction",
    "Interactions",
    "CompressedInteractions",
    "CompressedInteractionsUser",
    "TripletInteractions",
    "train_test_split",
    "user_based_split",
    "siphash24",
    "PaddedWindows",
    "StreamWindows",
    "extract_windows",
    "extract_padded_windows",
    "pad_windows",
    "to_streams",
    "pack_streams",
]

_ID_DTYPE = np.int64


def _as_rng(rng: "np.random.Generator | int | None") -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


def _atomic_savez(path: str, kind: str, **payload) -> None:
    """Write an ``.npz`` atomically (temp file + rename, the same pattern as
    the dataset cache, reference ``src/datasets.rs:36-55``)."""
    import os
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, kind=np.str_(kind), **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_npz(path: str, expect_kind: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        got = str(z["kind"])
        if got != expect_kind:
            raise ValueError(
                f"{path} holds a {got!r} container, expected {expect_kind!r}"
            )
        return {k: z[k] for k in z.files if k != "kind"}


@dataclasses.dataclass(frozen=True)
class Interaction:
    """A single (user, item, timestamp) event (reference ``src/data.rs:16-51``)."""

    user_id: int
    item_id: int
    timestamp: int

    def weight(self) -> float:
        """Interaction weight — hard-coded 1.0, implicit feedback
        (reference ``src/data.rs:44-46``)."""
        return 1.0


class Interactions:
    """A collection of individual (user, item, timestamp) interactions.

    Columnar equivalent of the reference's ``Interactions``
    (``src/data.rs:91-211``).
    """

    def __init__(
        self,
        num_users: int,
        num_items: int,
        user_ids: Optional[np.ndarray] = None,
        item_ids: Optional[np.ndarray] = None,
        timestamps: Optional[np.ndarray] = None,
    ):
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        empty = np.zeros((0,), dtype=_ID_DTYPE)
        self.user_ids = empty if user_ids is None else np.asarray(user_ids, dtype=_ID_DTYPE)
        self.item_ids = empty if item_ids is None else np.asarray(item_ids, dtype=_ID_DTYPE)
        self.timestamps = (
            empty if timestamps is None else np.asarray(timestamps, dtype=_ID_DTYPE)
        )
        if not (len(self.user_ids) == len(self.item_ids) == len(self.timestamps)):
            raise ValueError("user_ids, item_ids, timestamps must have equal lengths")

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        user_ids: np.ndarray,
        item_ids: np.ndarray,
        timestamps: np.ndarray,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
    ) -> "Interactions":
        """Build from columnar arrays, inferring shape as max-id + 1 when not
        given (reference: ``From<Vec<Interaction>>``, ``src/data.rs:200-211``)."""
        user_ids = np.asarray(user_ids, dtype=_ID_DTYPE)
        item_ids = np.asarray(item_ids, dtype=_ID_DTYPE)
        timestamps = np.asarray(timestamps, dtype=_ID_DTYPE)
        if num_users is None:
            num_users = int(user_ids.max()) + 1 if len(user_ids) else 0
        if num_items is None:
            num_items = int(item_ids.max()) + 1 if len(item_ids) else 0
        return cls(num_users, num_items, user_ids, item_ids, timestamps)

    # -- basic container ops ----------------------------------------------

    def push(self, user_id: int, item_id: int, timestamp: int) -> None:
        """Append one interaction (reference ``src/data.rs:108-110``).

        O(n); intended for small hand-built fixtures — bulk data should use
        :meth:`from_arrays`.
        """
        self.user_ids = np.append(self.user_ids, _ID_DTYPE(user_id))
        self.item_ids = np.append(self.item_ids, _ID_DTYPE(item_id))
        self.timestamps = np.append(self.timestamps, _ID_DTYPE(timestamp))

    def __len__(self) -> int:
        return len(self.user_ids)

    def is_empty(self) -> bool:
        return len(self) == 0

    def __iter__(self) -> Iterator[Interaction]:
        """Iterate single events (reference exposes ``&[Interaction]`` via
        ``data()``, ``src/data.rs:174-180``). Columnar access is the fast
        path; this is API-parity sugar."""
        for u, i, t in zip(self.user_ids, self.item_ids, self.timestamps):
            yield Interaction(int(u), int(i), int(t))

    def __getitem__(self, idx: int) -> Interaction:
        return Interaction(
            int(self.user_ids[idx]), int(self.item_ids[idx]), int(self.timestamps[idx])
        )

    def data(self) -> List[Interaction]:
        """All events as a list (reference ``data()``, ``src/data.rs:113``).
        Columnar access (``user_ids``/``item_ids``/``timestamps``) is the
        fast path; this materializes per-event objects."""
        return list(self)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_users, self.num_items)

    def shuffle(self, rng: "np.random.Generator | int | None" = None) -> None:
        """Shuffle interactions in place (reference ``src/data.rs:128-130``)."""
        rng = _as_rng(rng)
        perm = rng.permutation(len(self))
        self.user_ids = self.user_ids[perm]
        self.item_ids = self.item_ids[perm]
        self.timestamps = self.timestamps[perm]

    def _take(self, index: np.ndarray) -> "Interactions":
        return Interactions(
            self.num_users,
            self.num_items,
            self.user_ids[index],
            self.item_ids[index],
            self.timestamps[index],
        )

    def split_at(self, idx: int) -> Tuple["Interactions", "Interactions"]:
        """Split at ``idx`` returning (head, tail) (reference ``src/data.rs:133-146``)."""
        sel = np.arange(len(self))
        return self._take(sel[:idx]), self._take(sel[idx:])

    def split_by(self, predicate: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]):
        """Split by a vectorized predicate over (user_ids, item_ids, timestamps).

        Returns (matching, non_matching), mirroring ``split_by``
        (``src/data.rs:149-172``) but with a columnar predicate.
        """
        mask = np.asarray(predicate(self.user_ids, self.item_ids, self.timestamps), dtype=bool)
        return self._take(mask), self._take(~mask)

    def to_compressed(self) -> "CompressedInteractions":
        return CompressedInteractions.from_interactions(self)

    def to_triplet(self) -> "TripletInteractions":
        return TripletInteractions(
            self.num_users,
            self.num_items,
            self.user_ids.copy(),
            self.item_ids.copy(),
            self.timestamps.copy(),
        )

    # -- serialization (reference derives Serialize/Deserialize on all data
    # containers, ``src/data.rs:91``; split datasets are persistable
    # artifacts there) ------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist to ``.npz`` (atomic write)."""
        _atomic_savez(
            path, "interactions",
            num_users=self.num_users, num_items=self.num_items,
            user_ids=self.user_ids, item_ids=self.item_ids,
            timestamps=self.timestamps,
        )

    @classmethod
    def load(cls, path: str) -> "Interactions":
        z = _load_npz(path, "interactions")
        return cls(
            int(z["num_users"]), int(z["num_items"]),
            z["user_ids"], z["item_ids"], z["timestamps"],
        )


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------


def train_test_split(
    interactions: Interactions,
    rng: "np.random.Generator | int | None",
    test_fraction: float,
) -> Tuple[Interactions, Interactions]:
    """Randomly split interactions into (train, test).

    Matches the reference exactly: shuffle in place, then the *head*
    ``test_fraction`` of rows is the test set (``src/data.rs:53-64``).
    """
    rng = _as_rng(rng)
    interactions.shuffle(rng)
    test, train = interactions.split_at(int(test_fraction * len(interactions)))
    return train, test


_SIP_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(x: np.ndarray, b: int) -> np.ndarray:
    b = np.uint64(b)
    return ((x << b) | (x >> (np.uint64(64) - b))) & _SIP_MASK


def _sipround(v0, v1, v2, v3):
    v0 = (v0 + v1) & _SIP_MASK
    v1 = _rotl(v1, 13)
    v1 ^= v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _SIP_MASK
    v3 = _rotl(v3, 16)
    v3 ^= v2
    v0 = (v0 + v3) & _SIP_MASK
    v3 = _rotl(v3, 21)
    v3 ^= v0
    v2 = (v2 + v1) & _SIP_MASK
    v1 = _rotl(v1, 17)
    v1 ^= v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash24(key0: int, key1: int, values: np.ndarray) -> np.ndarray:
    """Vectorized SipHash-2-4 of each uint64 value, as 8 little-endian bytes.

    This is the keyed hash the reference uses for deterministic user-based
    splitting (``siphasher::sip::SipHasher`` + ``Hasher::write_usize``,
    ``src/data.rs:81-85``). Verified against the SipHash reference test
    vectors in ``tests/test_data.py``.
    """
    with np.errstate(over="ignore"):
        values = np.asarray(values, dtype=np.uint64)
        k0 = np.uint64(key0)
        k1 = np.uint64(key1)
        v0 = k0 ^ np.uint64(0x736F6D6570736575)
        v1 = k1 ^ np.uint64(0x646F72616E646F6D)
        v2 = k0 ^ np.uint64(0x6C7967656E657261)
        v3 = k1 ^ np.uint64(0x7465646279746573)
        v0 = np.broadcast_to(v0, values.shape).copy()
        v1 = np.broadcast_to(v1, values.shape).copy()
        v2 = np.broadcast_to(v2, values.shape).copy()
        v3 = np.broadcast_to(v3, values.shape).copy()

        # One full 8-byte block: the value itself.
        m = values
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m

        # Finalization block: total message length (8) in the top byte.
        b = np.uint64(8) << np.uint64(56)
        v3 ^= b
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= b

        v2 ^= np.uint64(0xFF)
        for _ in range(4):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)

        return v0 ^ v1 ^ v2 ^ v3


def user_based_split(
    interactions: Interactions,
    rng: "np.random.Generator | int | None",
    test_fraction: float,
) -> Tuple[Interactions, Interactions]:
    """Split so that no user appears in both sets (reference ``src/data.rs:69-88``).

    An interaction is a *train* row when
    ``siphash24(key0, key1, user_id) % 100_000 > test_fraction * 100_000``,
    with the two hash keys drawn from ``rng`` — deterministic given the RNG
    state, approximately ``test_fraction`` of users land in test.
    """
    rng = _as_rng(rng)
    denominator = 100_000
    train_cutoff = np.uint64(int(test_fraction * denominator))
    key0, key1 = (int(x) for x in rng.integers(0, 2**64, size=2, dtype=np.uint64))

    hashes = siphash24(key0, key1, interactions.user_ids.astype(np.uint64))
    is_train = (hashes % np.uint64(denominator)) > train_cutoff
    return interactions._take(is_train), interactions._take(~is_train)


# ---------------------------------------------------------------------------
# Compressed (CSR-by-user) layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedInteractionsUser:
    """One user's history, earliest-to-latest (reference ``src/data.rs:339-347``)."""

    user_id: int
    item_ids: np.ndarray
    timestamps: np.ndarray

    def __len__(self) -> int:
        return len(self.item_ids)

    def is_empty(self) -> bool:
        return len(self) == 0

    def chunks(self, chunk_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Chunked iterator: the *first* chunk is smallest, the remaining
        chunks are all exactly ``chunk_size`` (reference ``src/data.rs:406-432``)."""
        n = len(self.item_ids)
        idx = 0
        while idx < n:
            rem = (n - idx) % chunk_size
            size = chunk_size if rem == 0 else rem
            yield self.item_ids[idx : idx + size], self.timestamps[idx : idx + size]
            idx += size


class CompressedInteractions:
    """CSR-by-user interactions, sorted stably by (user_id, timestamp).

    Reference: ``src/data.rs:223-329``.
    """

    def __init__(
        self,
        num_users: int,
        num_items: int,
        user_pointers: np.ndarray,
        item_ids: np.ndarray,
        timestamps: np.ndarray,
    ):
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.user_pointers = np.asarray(user_pointers, dtype=_ID_DTYPE)
        self.item_ids = np.asarray(item_ids, dtype=_ID_DTYPE)
        self.timestamps = np.asarray(timestamps, dtype=_ID_DTYPE)

    @classmethod
    def from_interactions(cls, interactions: Interactions) -> "CompressedInteractions":
        # Stable sort by (user_id, timestamp) — equal keys keep input order,
        # matching Rust's stable `sort_by` (`src/data.rs:236-265`). The
        # native (C++) backend handles large datasets; numpy lexsort (also
        # stable) is the fallback.
        from . import _native

        if _native.available():
            order = _native.stable_order_by_user_ts(
                interactions.user_ids, interactions.timestamps
            )
        else:
            order = np.lexsort((interactions.timestamps, interactions.user_ids))
        item_ids = interactions.item_ids[order]
        timestamps = interactions.timestamps[order]
        counts = np.bincount(
            interactions.user_ids, minlength=interactions.num_users
        ).astype(_ID_DTYPE)
        user_pointers = np.zeros(interactions.num_users + 1, dtype=_ID_DTYPE)
        np.cumsum(counts, out=user_pointers[1:])
        return cls(
            interactions.num_users,
            interactions.num_items,
            user_pointers,
            item_ids,
            timestamps,
        )

    def __len__(self) -> int:
        return len(self.item_ids)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_users, self.num_items)

    def get_user(self, user_id: int) -> Optional[CompressedInteractionsUser]:
        """Reference ``src/data.rs:277-290``."""
        if user_id >= self.num_users or user_id < 0:
            return None
        start = self.user_pointers[user_id]
        stop = self.user_pointers[user_id + 1]
        return CompressedInteractionsUser(
            user_id, self.item_ids[start:stop], self.timestamps[start:stop]
        )

    def iter_users(self) -> Iterator[CompressedInteractionsUser]:
        """Reference ``src/data.rs:268-274``."""
        for user_id in range(self.num_users):
            yield self.get_user(user_id)

    def user_lengths(self) -> np.ndarray:
        return np.diff(self.user_pointers)

    def to_interactions(self) -> Interactions:
        """Round-trip back to flat interactions (reference ``src/data.rs:308-328``)."""
        lengths = self.user_lengths()
        user_ids = np.repeat(np.arange(self.num_users, dtype=_ID_DTYPE), lengths)
        return Interactions(
            self.num_users,
            self.num_items,
            user_ids,
            self.item_ids.copy(),
            self.timestamps.copy(),
        )

    # -- serialization (reference ``src/data.rs:227``) -----------------------

    def save(self, path: str) -> None:
        """Persist to ``.npz`` (atomic write)."""
        _atomic_savez(
            path, "compressed_interactions",
            num_users=self.num_users, num_items=self.num_items,
            user_pointers=self.user_pointers, item_ids=self.item_ids,
            timestamps=self.timestamps,
        )

    @classmethod
    def load(cls, path: str) -> "CompressedInteractions":
        z = _load_npz(path, "compressed_interactions")
        return cls(
            int(z["num_users"]), int(z["num_items"]),
            z["user_pointers"], z["item_ids"], z["timestamps"],
        )


# ---------------------------------------------------------------------------
# Triplet (COO) layout
# ---------------------------------------------------------------------------


class TripletInteractions:
    """Interactions in COO form with minibatch iteration.

    Reference ``src/data.rs:434-575``. Unused by the sequence models (which
    train from :class:`CompressedInteractions`) but part of the public data
    API for factorization-style consumers.
    """

    def __init__(self, num_users, num_items, user_ids, item_ids, timestamps):
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.user_ids = np.asarray(user_ids, dtype=_ID_DTYPE)
        self.item_ids = np.asarray(item_ids, dtype=_ID_DTYPE)
        self.timestamps = np.asarray(timestamps, dtype=_ID_DTYPE)

    def __len__(self) -> int:
        return len(self.user_ids)

    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_users, self.num_items)

    def iter_minibatch(self, minibatch_size: int, start: int = 0, stop: Optional[int] = None):
        """Iterate over full minibatches; a trailing partial batch is dropped,
        matching the reference (``src/data.rs:539-559``)."""
        stop = len(self) if stop is None else stop
        idx = start
        while idx + minibatch_size <= stop:
            sl = slice(idx, idx + minibatch_size)
            yield (self.user_ids[sl], self.item_ids[sl], self.timestamps[sl])
            idx += minibatch_size

    def iter_minibatch_partitioned(self, minibatch_size: int, num_partitions: int):
        """Reference ``src/data.rs:466-477``."""
        chunk = len(self) // num_partitions
        return [
            self.iter_minibatch(minibatch_size, start=i * chunk, stop=(i + 1) * chunk)
            for i in range(num_partitions)
        ]

    # -- serialization (reference ``src/data.rs:435``) -----------------------

    def save(self, path: str) -> None:
        """Persist to ``.npz`` (atomic write)."""
        _atomic_savez(
            path, "triplet_interactions",
            num_users=self.num_users, num_items=self.num_items,
            user_ids=self.user_ids, item_ids=self.item_ids,
            timestamps=self.timestamps,
        )

    @classmethod
    def load(cls, path: str) -> "TripletInteractions":
        z = _load_npz(path, "triplet_interactions")
        return cls(
            int(z["num_users"]), int(z["num_items"]),
            z["user_ids"], z["item_ids"], z["timestamps"],
        )


# ---------------------------------------------------------------------------
# Window extraction → padded device batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PaddedWindows:
    """Padded ``[N, T]`` next-item-prediction windows.

    The TPU-native replacement for the reference's per-timestep index feeds:
    a window of item ids ``[i_0 .. i_{L-1}]`` yields inputs ``i_0..i_{L-2}``
    and targets ``i_1..i_{L-1}`` — ``L-1`` supervised timesteps, exactly the
    reference's per-sequence loss span (``src/models/sequence_model.rs:111-158``).
    Right-padded with zeros; ``mask[n, t] == 1`` iff timestep ``t`` of window
    ``n`` is supervised. ``lengths[n]`` counts supervised timesteps (== the
    reference's ``loss_idx + 1`` example counting).
    """

    inputs: np.ndarray  # [N, T] int32
    targets: np.ndarray  # [N, T] int32
    mask: np.ndarray  # [N, T] float32
    lengths: np.ndarray  # [N] int32
    # Packed layout only (see pack_windows): 1.0 where a new window begins
    # and the recurrent state must reset. None = one window per row.
    starts: Optional[np.ndarray] = None  # [N, T] float32

    def __len__(self) -> int:
        return self.inputs.shape[0]

    @property
    def num_examples(self) -> int:
        """Total supervised timesteps (the reference's `examples` count)."""
        return int(self.lengths.sum())


def extract_windows(
    interactions: CompressedInteractions,
    max_sequence_length: int,
    min_length: int = 3,
) -> List[np.ndarray]:
    """Cut each user's history into training windows.

    First-chunk-smallest chunking (``src/data.rs:406-432``) with windows of
    length ``> 2`` kept (``src/models/sequence_model.rs:76-83``).
    """
    windows: List[np.ndarray] = []
    pointers = interactions.user_pointers
    item_ids = interactions.item_ids
    T = max_sequence_length
    for u in range(interactions.num_users):
        start, stop = int(pointers[u]), int(pointers[u + 1])
        idx = start
        while idx < stop:
            rem = (stop - idx) % T
            size = T if rem == 0 else rem
            if size >= min_length:
                windows.append(item_ids[idx : idx + size])
            idx += size
    return windows


def extract_padded_windows(
    interactions: CompressedInteractions,
    max_sequence_length: int,
    min_length: int = 3,
) -> PaddedWindows:
    """Vectorized :func:`extract_windows` + :func:`pad_windows` in one pass —
    no Python per-user loop. Uses the native (C++) backend when available
    (:mod:`._native`), else O(total windows) numpy fancy-indexing.
    Same first-chunk-smallest / len > 2 semantics either way.
    """
    from . import _native

    if _native.available():
        inputs, targets, mask, lengths = _native.extract_padded_windows(
            interactions.user_pointers,
            interactions.item_ids,
            max_sequence_length,
            min_length,
        )
        return PaddedWindows(inputs=inputs, targets=targets, mask=mask, lengths=lengths)
    return _extract_padded_windows_numpy(interactions, max_sequence_length, min_length)


def _extract_padded_windows_numpy(
    interactions: CompressedInteractions,
    max_sequence_length: int,
    min_length: int = 3,
) -> PaddedWindows:
    """Pure-numpy reference implementation of :func:`extract_padded_windows`."""
    T = max_sequence_length
    lengths = np.diff(interactions.user_pointers)
    starts = interactions.user_pointers[:-1]
    item_ids = interactions.item_ids

    active = lengths > 0
    L = lengths[active]
    S = starts[active]
    k = -(-L // T)  # windows per user
    r = L - (k - 1) * T  # first-chunk size (== T when L % T == 0)

    n_windows = int(k.sum())
    if n_windows == 0:
        return PaddedWindows(
            inputs=np.zeros((0, T), np.int32),
            targets=np.zeros((0, T), np.int32),
            mask=np.zeros((0, T), np.float32),
            lengths=np.zeros((0,), np.int32),
        )
    # Per-window user row and within-user window ordinal.
    win_user = np.repeat(np.arange(len(L)), k)
    user_first_win = np.concatenate([[0], np.cumsum(k)[:-1]])
    ordinal = np.arange(n_windows) - np.repeat(user_first_win, k)

    win_len = np.where(ordinal == 0, r[win_user], T)
    win_start = S[win_user] + np.where(
        ordinal == 0, 0, r[win_user] + (ordinal - 1) * T
    )

    keep = win_len >= min_length
    win_len = win_len[keep]
    win_start = win_start[keep]
    n = len(win_len)

    pos = np.arange(T)[None, :]
    sup = pos < (win_len - 1)[:, None]  # supervised timestep mask
    src = win_start[:, None] + pos
    src = np.minimum(src, len(item_ids) - 1)
    gathered = item_ids[src]
    nxt = item_ids[np.minimum(src + 1, len(item_ids) - 1)]
    inputs = np.where(sup, gathered, 0).astype(np.int32)
    targets = np.where(sup, nxt, 0).astype(np.int32)
    return PaddedWindows(
        inputs=inputs,
        targets=targets,
        mask=sup.astype(np.float32),
        lengths=(win_len - 1).astype(np.int32),
    )


@dataclasses.dataclass
class StreamWindows:
    """The device batch layout: one item-id *stream* per row.

    ``stream[n]`` holds window item ids back-to-back in ``T + 1`` slots;
    position ``t < T`` is supervised iff ``mask[n, t] == 1``, in which case
    input = ``stream[n, t]`` and target = ``stream[n, t + 1]`` (the
    reference's next-item pairs, ``src/models/sequence_model.rs:111-158``).
    This is the row-traffic-optimal layout on TPU: the training step gathers
    ``B * (T + 1)`` table rows for inputs AND targets combined (a separate
    inputs/targets pair layout gathers ``2 * B * T`` and scatters 50% more
    row gradients — the measured hot cost of the step).

    ``starts[n, t] == 1`` marks positions where a new window begins and the
    recurrent towers must reset state (packed rows); ``None`` = one window
    per row. ``lengths[n]`` counts supervised timesteps (the reference's
    ``loss_idx + 1`` example accounting).
    """

    stream: np.ndarray  # [N, T + 1] int32
    mask: np.ndarray  # [N, T] float32
    lengths: np.ndarray  # [N] int32
    starts: Optional[np.ndarray] = None  # [N, T] float32

    def __len__(self) -> int:
        return self.stream.shape[0]

    @property
    def num_examples(self) -> int:
        """Total supervised timesteps (the reference's `examples` count)."""
        return int(self.lengths.sum())


def to_streams(padded: PaddedWindows) -> StreamWindows:
    """One-window-per-row stream layout of padded windows.

    Within one window ``inputs[t + 1] == targets[t]``, so the stream is just
    the first input followed by the targets — no data movement beyond a
    column concat.
    """
    n, T = padded.inputs.shape
    first = padded.inputs[:, :1] if n else np.zeros((0, 1), np.int32)
    stream = np.concatenate([first, padded.targets], axis=1).astype(np.int32)
    return StreamWindows(
        stream=stream, mask=padded.mask.astype(np.float32), lengths=padded.lengths
    )


def pack_streams(padded: PaddedWindows, max_sequence_length: int) -> StreamWindows:
    """Pack variable-length windows into dense stream rows (first-fit
    decreasing).

    The reference pads nothing (it feeds one sequence at a time); padded
    batches waste MXU work on masked timesteps (ML-100K at T=128 is ~35%
    padding). Packing places several windows end-to-end in one stream row —
    a window with ``s`` supervised steps occupies ``s + 1`` slots of the
    ``T + 1`` capacity; ``starts`` marks window starts where the towers
    reset, so packed training is mathematically identical to padded
    training (same per-timestep losses, same example count) at higher
    utilization. New capability with no reference counterpart (SURVEY.md §7
    "variable-length packing").
    """
    T = max_sequence_length
    n = len(padded)
    if n == 0:
        return StreamWindows(
            stream=np.zeros((0, T + 1), np.int32),
            mask=np.zeros((0, T), np.float32),
            lengths=np.zeros((0,), np.int32),
            starts=np.zeros((0, T), np.float32),
        )

    lengths = padded.lengths.astype(np.int64)  # supervised steps per window
    # Windows with no supervised steps carry nothing to pack (a raw window
    # of length <= 1 pads to zero supervised steps). Slot cost per window is
    # lengths + 1 (the stream stores the final target too); bin capacity is
    # T + 1 slots.
    sizes = np.where(lengths >= 1, lengths + 1, 0).astype(np.int32)

    from . import _native

    if _native.available():
        bin_of, offset_of, m = _native.pack_plan(sizes, T + 1)
    else:
        bin_of, offset_of, m = _pack_plan_numpy(sizes, T + 1)

    stream = np.zeros((m, T + 1), dtype=np.int32)
    mask = np.zeros((m, T), dtype=np.float32)
    starts = np.zeros((m, T), dtype=np.float32)
    out_lengths = np.zeros((m,), dtype=np.int32)

    w_idx = np.nonzero(bin_of >= 0)[0]
    if len(w_idx):
        sup = lengths[w_idx]  # supervised steps
        rows = bin_of[w_idx]
        offs = offset_of[w_idx]

        # Stream slots: [inputs[w, 0], targets[w, 0 .. sup-1]].
        slot_counts = sup + 1
        w_rep = np.repeat(w_idx, slot_counts)
        first_slot = np.concatenate([[0], np.cumsum(slot_counts)[:-1]])
        pos = np.arange(int(slot_counts.sum())) - np.repeat(first_slot, slot_counts)
        dest = np.repeat(rows, slot_counts) * (T + 1) + np.repeat(offs, slot_counts) + pos
        vals = np.where(
            pos == 0,
            padded.inputs[w_rep, 0],
            padded.targets[w_rep, np.maximum(pos - 1, 0)],
        )
        stream.reshape(-1)[dest] = vals

        # Supervised positions: the first `sup` slots of each window.
        m_rep = np.repeat(w_idx, sup)
        first_m = np.concatenate([[0], np.cumsum(sup)[:-1]])
        mpos = np.arange(int(sup.sum())) - np.repeat(first_m, sup)
        mdest = np.repeat(rows, sup) * T + np.repeat(offs, sup) + mpos
        mask.reshape(-1)[mdest] = 1.0

        starts[rows, offs] = 1.0
        np.add.at(out_lengths, rows, sup.astype(np.int32))

    return StreamWindows(
        stream=stream, mask=mask, lengths=out_lengths, starts=starts
    )


def _pack_plan_numpy(
    sizes: np.ndarray, capacity: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """First-fit-decreasing bin plan (pure-Python fallback; the native
    backend implements the identical algorithm, ``sbr_pack_plan``).

    After descending sort, scanning bins newest-to-oldest finds a fit
    quickly (older bins are fuller); total cost is near-linear in practice.
    Items with size < 1 are skipped (``bin_of = -1``).
    """
    n = len(sizes)
    order = np.argsort(-sizes.astype(np.int64), kind="stable")
    bin_of = np.full(n, -1, dtype=np.int64)
    offset_of = np.zeros(n, dtype=np.int64)
    bin_fill: List[int] = []
    for w in order:
        L = int(sizes[w])
        if L < 1:
            continue
        placed = False
        for b in range(len(bin_fill) - 1, -1, -1):
            if bin_fill[b] + L <= capacity:
                bin_of[w] = b
                offset_of[w] = bin_fill[b]
                bin_fill[b] += L
                placed = True
                break
        if not placed:
            bin_of[w] = len(bin_fill)
            offset_of[w] = 0
            bin_fill.append(L)
    return bin_of, offset_of, len(bin_fill)


def pad_windows(windows: Sequence[np.ndarray], max_sequence_length: int) -> PaddedWindows:
    """Pad variable-length windows into dense ``[N, T]`` batches."""
    T = max_sequence_length
    n = len(windows)
    inputs = np.zeros((n, T), dtype=np.int32)
    targets = np.zeros((n, T), dtype=np.int32)
    mask = np.zeros((n, T), dtype=np.float32)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, w in enumerate(windows):
        L = len(w)
        inputs[i, : L - 1] = w[:-1]
        targets[i, : L - 1] = w[1:]
        mask[i, : L - 1] = 1.0
        lengths[i] = L - 1
    return PaddedWindows(inputs=inputs, targets=targets, mask=mask, lengths=lengths)
