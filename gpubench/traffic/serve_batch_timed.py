"""Offline batch serving of timed histories: ``recommend_batch(histories,
k, exclude_seen=True, return_scores=True, timestamps=times)`` on batches of
``users_per_batch`` histories, back to back from one caller (a closed
loop), from a pool of ``pool_batches`` batches drawn in set-up.

A history's length is log-normal (``history_length_median``,
``history_length_sigma``), rounded and clipped to ``history_lengths``; its
item ids are Zipf over the catalog; its times (int seconds) start uniform
over ``time_start`` and go on by nondecreasing gaps, a ``session_share`` of
them log-uniform over ``session_gap_s``, the rest over ``between_gap_s``.
The caller sends each history as an int64 array of ids and one of times;
the check reads it as a list of ids carrying its times (:class:`Timed`), so
the reference and the seen filter read the ids as ``serve_batch``'s. The model
is built first: a program without the family fails before the pool is
drawn. Checked as ``serve_batch``: a sample of the served users against
the reference's exact lists and scores."""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Tuple

import numpy as np

from gpubench import gen, program, weights
from gpubench.traffic import serve_batch


class Timed(list):
    """A history's item ids, with their times in ``times`` (int seconds)."""

    __slots__ = ("times",)


def _log_uniform(rng: np.random.Generator, lo: float, hi: float, count: int) -> np.ndarray:
    return np.exp(rng.uniform(np.log(lo), np.log(hi), count))


def draw(rng: np.random.Generator, count: int, num_items: int, p: Dict
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(ids, times, lengths)`` of ``count`` histories drawn by the
    parameters ``p`` (above), the ids and times end to end, int64."""
    lo, hi = p["history_lengths"]
    lens = rng.lognormal(np.log(p["history_length_median"]), p["history_length_sigma"], count)
    lens = np.clip(np.rint(lens), lo, hi).astype(np.int64)
    total = int(lens.sum())
    ids = gen.zipf_ids(rng, total, num_items, p["zipf_exponent"])
    in_session = rng.random(total) < p["session_share"]
    gaps = np.where(in_session, _log_uniform(rng, *p["session_gap_s"], total),
                    _log_uniform(rng, *p["between_gap_s"], total))
    steps = np.rint(gaps).astype(np.int64)
    firsts = np.cumsum(lens) - lens
    steps[firsts] = rng.integers(*p["time_start"], count)
    ends = np.cumsum(steps)
    return ids, ends - np.repeat(ends[firsts] - steps[firsts], lens), lens


def as_timed(ids: np.ndarray, times: np.ndarray, lens: np.ndarray) -> List[Timed]:
    """The histories of :func:`draw` as lists of Python ints with their times."""
    ids, times, out, a = ids.tolist(), times.tolist(), [], 0
    for n in lens.tolist():
        h = Timed(ids[a : a + n])
        h.times = times[a : a + n]
        out.append(h)
        a += n
    return out


def timed_histories(rng: np.random.Generator, count: int, num_items: int, p: Dict) -> List[Timed]:
    """``count`` timed histories drawn by the parameters ``p`` (above)."""
    return as_timed(*draw(rng, count, num_items, p))


def _positions() -> int:
    """``hstu_apply.positions``: the positions the program's HSTU tower has
    computed, padding included. A program that serves the family without
    the counter raises here, so that a renamed counter fails the run."""
    return int(importlib.import_module("sbr_rs_tpu_torch.models.towers").hstu_apply.positions)


class Traffic(serve_batch.Traffic):
    span_name = "recommend_batch"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.cell["traffic"]
        self.model = program.build(cfg, ctx.seed, ctx.cell["weights"], ctx.device)
        self.k = int(p["k"])
        self.u = int(p["users_per_batch"])
        rng = np.random.default_rng(weights.derived_seed(ctx.seed, 30))
        # Each batch twice: as the caller sends it, one int64 array of ids
        # and one of times a history, and as the check reads it (Timed).
        self.pool, self.requests = [], []
        for _ in range(int(p["pool_batches"])):
            ids, times, lens = draw(rng, self.u, cfg["num_items"], p)
            cuts = np.cumsum(lens)[:-1]
            self.pool.append(as_timed(ids, times, lens))
            self.requests.append((np.split(ids, cuts), np.split(times, cuts)))
        self.order = np.random.default_rng(weights.derived_seed(ctx.seed, 31)).permutation(len(self.pool))
        t = int(cfg["max_sequence_length"])
        lens = [np.minimum([len(h) for h in batch], t) for batch in self.pool]
        # Per batch: the valid positions and the keys they attend (causal).
        self.valid = [(float(x.sum()), float((x * (x + 1) / 2).sum())) for x in lens]
        self.served = []
        self.batch_s = []
        self.next = 0
        self.failed = 0
        self.routes = set()
        self.positions_open = None

    def _serve(self, b: int):
        t = time.perf_counter()
        histories, times = self.requests[b]
        ids, vals = self.model.recommend_batch(histories, k=self.k, exclude_seen=True, return_scores=True,
                                               timestamps=times)
        if self.ctx.fault == "answer":  # a planted fault: each list's last item replaced
            n = self.ctx.cfg["num_items"]
            ids = [row[:-1] + [(row[-1] + 1) % n] for row in ids]
        self.batch_s.append(time.perf_counter() - t)
        return ids, vals

    def open_window(self):
        super().open_window()
        self.positions_open = _positions()

    def reading(self) -> Dict:
        """``serve_batch``'s, and the tower's valid positions and causal keys
        over the window's batches (``tower_positions``, ``tower_keys``) and
        the positions it computed (``tower_positions_computed``, from the
        program's counter)."""
        out = super().reading()
        done = [b for b, ids, _ in self.served if ids is not None]
        out["tower_positions"] = sum(self.valid[b][0] for b in done)
        out["tower_keys"] = sum(self.valid[b][1] for b in done)
        out["tower_positions_computed"] = _positions() - self.positions_open
        return out
