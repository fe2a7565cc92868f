"""Built-in datasets for easy testing and experimentation.

Reference: ``src/datasets.rs`` — downloads Movielens 100K as CSV
(``user_id,item_id,rating,timestamp``; the ``rating`` column is ignored on
load, implicit feedback), caches it under ``~/.sbr-rs`` with a
download-to-temp-then-atomic-rename pattern (``src/datasets.rs:36-55``).

This module keeps the same cache + atomic-rename behavior (under
``~/.sbr-rs-tpu``) and provides synthetic large-catalog generators for the
sharded-table benchmark configs.

A copy of :mod:`sbr_rs_tpu.datasets` (importing that module would load
jax): ``synthetic_interactions`` gives the same arrays for the same seed.
Unlike the JAX package it knows no machine-specific local copy of ML-100K:
give ``path`` or ``$SBR_TPU_ML100K``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .data import Interactions
from .errors import DatasetError

ML_100K_URL = "https://github.com/maciejkula/sbr-rs/raw/master/data.csv"
_CACHE_DIR_NAME = ".sbr-rs-tpu"


def _data_dir() -> Path:
    """Cache directory, created on demand (reference ``src/datasets.rs:24-34``)."""
    home = Path(os.environ.get("SBR_TPU_HOME", Path.home()))
    path = home / _CACHE_DIR_NAME
    path.mkdir(parents=True, exist_ok=True)
    return path


def _load_interactions_csv(path: Path) -> Interactions:
    """Parse a ``user_id,item_id,rating,timestamp`` CSV; ``rating`` ignored
    (reference deserializes into a struct without a rating field,
    ``src/data.rs:16-21`` + ``src/datasets.rs:57-60``). Uses the native
    (C++) parser when available; numpy loadtxt is the fallback."""
    from . import _native

    if _native.available():
        users, items, ts = _native.parse_interactions_csv(str(path))
        return Interactions.from_arrays(users, items, ts)
    raw = np.loadtxt(
        path, delimiter=",", skiprows=1, dtype=np.int64, usecols=(0, 1, 3), ndmin=2
    )
    return Interactions.from_arrays(raw[:, 0], raw[:, 1], raw[:, 2])


def _download(url: str, dest: Path) -> None:
    """Download to a temp file then atomically rename into the cache
    (reference ``src/datasets.rs:36-55``)."""
    import urllib.request

    fd, tmp = tempfile.mkstemp(dir=str(dest.parent))
    os.close(fd)
    try:
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def download_movielens_100k(path: Optional[str] = None) -> Interactions:
    """Load the Movielens 100K dataset, downloading and caching if needed.

    Reference: ``src/datasets.rs:66-71``. Resolution order:

    1. explicit ``path`` argument,
    2. ``$SBR_TPU_ML100K`` environment variable,
    3. the cache file ``~/.sbr-rs-tpu/movielens_100K.csv``,
    4. network download from the upstream repository.
    """
    if path is not None:
        return _load_interactions_csv(Path(path))
    env_path = os.environ.get("SBR_TPU_ML100K")
    if env_path:
        return _load_interactions_csv(Path(env_path))

    cached = _data_dir() / "movielens_100K.csv"
    if cached.exists():
        return _load_interactions_csv(cached)

    try:
        _download(ML_100K_URL, cached)
    except Exception as exc:  # noqa: BLE001 — surface as a typed error
        raise DatasetError(
            f"Could not obtain Movielens 100K: no local copy and download failed ({exc})."
        ) from exc
    return _load_interactions_csv(cached)


def load_goodbooks(path: str, max_interactions: int = 1_000_000) -> Interactions:
    """Load the goodbooks-10k ratings CSV (``user_id,book_id,rating``).

    Reference: ``examples/lstm_hyperopt.rs:30-40`` — the row's position in
    the file is its timestamp (the CSV has no time column), rows are sorted
    stably by user, and the first ``max_interactions`` are kept.
    """
    raw = np.loadtxt(
        path, delimiter=",", skiprows=1, dtype=np.int64, usecols=(0, 1), ndmin=2
    )
    timestamps = np.arange(len(raw), dtype=np.int64)
    order = np.argsort(raw[:, 0], kind="stable")[:max_interactions]
    return Interactions.from_arrays(raw[order, 0], raw[order, 1], timestamps[order])


def dummy_interactions(num_users: int = 100, num_items: int = 50) -> Interactions:
    """Deterministic fixture: every user interacts with items
    ``1000..1000+num_items`` in order (reference
    ``examples/lstm_hyperopt.rs:42-55``)."""
    user_ids = np.repeat(np.arange(num_users, dtype=np.int64), num_items)
    item_ids = np.tile(1000 + np.arange(num_items, dtype=np.int64), num_users)
    timestamps = np.tile(np.arange(num_items, dtype=np.int64), num_users)
    return Interactions.from_arrays(user_ids, item_ids, timestamps)


def synthetic_interactions(
    num_users: int,
    num_items: int,
    interactions_per_user: int,
    rng: "np.random.Generator | int | None" = 0,
    zipf_exponent: float = 1.05,
) -> Interactions:
    """Generate a synthetic implicit-feedback dataset with a long-tailed
    item popularity distribution — used by the large-catalog (10M/100M item)
    sharded-table benchmark configs, which have no reference-dataset
    counterpart."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    n = num_users * interactions_per_user
    user_ids = np.repeat(np.arange(num_users, dtype=np.int64), interactions_per_user)
    # Genuinely long-tailed popularity: inverse-CDF of a power law
    # p(rank) ∝ rank^-s truncated to [1, num_items]. s == 1 degenerates to
    # log-uniform (classic Zipf); hot rows dominate traffic either way.
    u = rng.random(n)
    s = float(zipf_exponent)
    if abs(s - 1.0) < 1e-9:
        ranks = np.floor(num_items ** u).astype(np.int64)
    else:
        ranks = np.floor(
            ((num_items ** (1.0 - s) - 1.0) * u + 1.0) ** (1.0 / (1.0 - s))
        ).astype(np.int64)
    item_ids = np.clip(ranks - 1, 0, num_items - 1)
    timestamps = np.tile(np.arange(interactions_per_user, dtype=np.int64), num_users)
    return Interactions(num_users, num_items, user_ids, item_ids, timestamps)
