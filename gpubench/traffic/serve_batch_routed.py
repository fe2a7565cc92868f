"""Offline batch serving through a tower that routes its tokens to experts
(the ``mla_moe`` family): ``recommend_batch(histories, k, exclude_seen=True,
return_scores=True)`` on batches of ``users_per_batch`` histories, back to
back from one caller (a closed loop), from a pool of ``pool_batches``
batches drawn in set-up. The lengths follow ``serve_batch_timed``'s
log-normal law (``history_length_median``, ``history_length_sigma``,
rounded and clipped to ``history_lengths``) as a fixed multiset: each batch
holds the law's quantiles at ``(i + 0.5) / U``, ``i < U``, in the seed's
order, as ``serve_batch`` serves a fixed multiset of lengths. A tower whose
cost grows with every position would otherwise run each seed's pool at
another cost (the mean of 4,096 random draws spreads 1.2 % from seed to
seed). The item ids are Zipf over the catalog, as ``serve_batch_timed``
draws them; no times. The caller sends each history as an int64 array.

Checked as ``serve_batch``, a sample of the served users against the
reference's exact lists and scores, with one rule for the router's near
ties. The program and the reference round differently, so where the
``k``-th and the ``(k + 1)``-th biased choice scores of a token lie within
that rounding the two may choose different experts, and the user's
representation moves far past any float32 limit. A user is excused when
their lists fail the limits **and** the reference's routing margin (the
least gap between those two scores over the tokens that reach the
representation, ``reference/mla_moe.py representations_and_margins``) is
under the workload's ``near_tie.margin``; every excused user is printed,
and their share of the checked users is a check of its own
(``excused_share``), as is ``padding_routed``: the batches whose tower
counters disagree with the traffic's own count (``positions`` its valid
positions, ``routed_tokens`` ``num_experts_per_tok`` a valid position and
MoE layer), so a batch whose padding reached the router fails the run."""

from __future__ import annotations

import importlib
import statistics
import time
from typing import Dict, Tuple

import numpy as np
import torch

from gpubench import gen, program, spec, weights
from gpubench.reference import precision, topk
from gpubench.traffic import serve_batch


def lengths(rng: np.random.Generator, count: int, p: Dict) -> np.ndarray:
    """``count`` history lengths, int64: the log-normal law's quantiles at
    ``(i + 0.5) / count``, rounded and clipped to ``history_lengths`` (the
    same multiset for every seed), in the seed's order."""
    lo, hi = p["history_lengths"]
    normal = statistics.NormalDist(np.log(p["history_length_median"]), p["history_length_sigma"])
    lens = np.exp([normal.inv_cdf((i + 0.5) / count) for i in range(count)])
    return rng.permutation(np.clip(np.rint(lens), lo, hi).astype(np.int64))


def draw(rng: np.random.Generator, count: int, num_items: int, p: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """``(ids, lengths)`` of ``count`` histories, int64, the ids end to end:
    :func:`lengths`, then Zipf ids."""
    lens = lengths(rng, count, p)
    return gen.zipf_ids(rng, int(lens.sum()), num_items, p["zipf_exponent"]), lens


def _counters() -> Tuple[int, int, int]:
    """``(positions, routed_tokens, max_expert_tokens)`` of the program's
    ``mla_moe_apply``. A program that serves the family without them raises
    here, so that a renamed counter fails the run."""
    tower = importlib.import_module("sbr_rs_tpu_torch.models.towers").mla_moe_apply
    return int(tower.positions), int(tower.routed_tokens), int(tower.max_expert_tokens)


class Traffic(serve_batch.Traffic):
    span_name = "recommend_batch"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.cell["traffic"]
        self.model = program.build(cfg, ctx.seed, ctx.cell["weights"], ctx.device)
        self.k = int(p["k"])
        self.u = int(p["users_per_batch"])
        rng = np.random.default_rng(weights.derived_seed(ctx.seed, 40))
        # Each batch twice: as the caller sends it (an int64 array a
        # history) and as the check reads it (lists of ints).
        self.pool, self.requests = [], []
        for _ in range(int(p["pool_batches"])):
            ids, lens = draw(rng, self.u, cfg["num_items"], p)
            arrays = np.split(ids, np.cumsum(lens)[:-1])
            self.requests.append(arrays)
            self.pool.append([a.tolist() for a in arrays])
        self.order = np.random.default_rng(weights.derived_seed(ctx.seed, 41)).permutation(len(self.pool))
        t = int(cfg["max_sequence_length"])
        lens = [np.minimum([len(h) for h in batch], t) for batch in self.pool]
        # Per batch: the valid positions and the keys they attend (causal).
        self.valid = [(int(x.sum()), float((x * (x + 1) / 2).sum())) for x in lens]
        moe_layers = int(cfg["num_hidden_layers"]) - int(cfg["first_k_dense_replace"])
        self.routed_per_position = int(cfg["num_experts_per_tok"]) * moe_layers
        self.served = []
        self.batch_s = []
        self.next = 0
        self.failed = 0
        self.routes = set()
        self.counted_open = None
        self.padding_routed = 0

    def _serve(self, b: int):
        before = _counters()
        t = time.perf_counter()
        ids, vals = self.model.recommend_batch(self.requests[b], k=self.k, exclude_seen=True, return_scores=True)
        if self.ctx.fault == "answer":  # a planted fault: each list's last item replaced
            n = self.ctx.cfg["num_items"]
            ids = [row[:-1] + [(row[-1] + 1) % n] for row in ids]
        self.batch_s.append(time.perf_counter() - t)
        positions, routed, _ = (a - z for a, z in zip(_counters(), before))
        valid = self.valid[b][0]
        if positions != valid or routed != valid * self.routed_per_position:
            self.padding_routed += 1
            print(f"batch {b}: the tower computed {positions} positions and {routed} token-expert pairs; "
                  f"its histories hold {valid} valid positions", flush=True)
        return ids, vals

    def open_window(self):
        super().open_window()
        self.counted_open = _counters()

    def work(self) -> Dict:
        """``serve_batch``'s, and over the window's batches the valid
        positions (``tower_positions``) beside the tower's counters: the
        positions it computed, the token-expert pairs and the busiest
        experts' tokens summed over the MoE layers (``tower_counters``)."""
        out = super().work()
        done = [b for b, ids, _ in self.served if ids is not None]
        out["tower_positions"] = sum(self.valid[b][0] for b in done)
        names = ("positions", "routed_tokens", "max_expert_tokens")
        out["tower_counters"] = dict(zip(names, (a - z for a, z in zip(_counters(), self.counted_open))))
        return out

    def reading(self) -> Dict:
        """``serve_batch``'s, and the tower's valid positions and causal keys
        over the window's batches (``tower_positions``, ``tower_keys``)."""
        out = super().reading()
        done = [b for b, ids, _ in self.served if ids is not None]
        out["tower_positions"] = sum(self.valid[b][0] for b in done)
        out["tower_keys"] = sum(self.valid[b][1] for b in done)
        return out

    def checks(self, control: bool = False) -> Dict:
        """The sample's gaps under the near-tie rule (module docstring), the
        excused share and the batches whose padding was routed; with
        ``control``, the reference in TF32 in the program's place, on the
        same users."""
        hist, ids, vals = self._sample()
        out = near_tie_gaps(self.ctx.cfg, self.ctx.cell, self.ctx.seed, self.ctx.device, hist, ids, vals, self.k,
                            control)
        out["padding_routed"] = float(self.padding_routed)
        return out


def near_tie_gaps(cfg: Dict, cell: Dict, seed: int, device, hist, served_ids, served_vals, k: int,
                  control: bool = False) -> Dict[str, float]:
    """``{"rank_gap", "score_err", "excused_share"}`` of the served lists:
    each user's gaps (``reference/topk.py served_gaps``), the largest over
    the users not excused, and the excused users' share; the excused and
    the near ties are printed."""
    n, d = int(cfg["num_items"]), int(cfg["embedding_dim"])
    w, limits = cell["weights"], cell["limits"]
    margin_limit = float(cell["near_tie"]["margin"])
    ref = spec.reference_module(cfg["family"])
    leaves = weights.tower_leaves(seed, cfg, w, device)

    def rows(ids):
        return weights.table_rows(seed, ids, n, d, w, device)

    def lists(reps, asked, tf32):
        with precision(tf32), torch.no_grad():
            return topk.catalog_topk(reps, hist, k, weights.chunks(seed, n, d, w, device), asked)

    asked = torch.tensor([list(s[:k]) + [-1] * (k - len(s[:k])) for s in served_ids], dtype=torch.int64)
    with precision(False), torch.no_grad():
        reps, margins = ref.representations_and_margins(cfg, leaves, rows, hist)
    if control:
        with precision(True), torch.no_grad():
            ctl_reps, _ = ref.representations_and_margins(cfg, leaves, rows, hist)
        ctl_v, ctl_i, _ = lists(ctl_reps, asked, True)
        served_ids, served_vals, asked = ctl_i.tolist(), ctl_v.cpu().numpy(), ctl_i
    ref_v, _, asked_s = lists(reps, asked, False)
    vals = torch.as_tensor(np.asarray(served_vals, dtype=np.float32))
    gaps = np.array([topk.served_gaps(ref_v[r : r + 1], asked_s[r : r + 1], [served_ids[r]], n, vals[r : r + 1])
                     for r in range(len(hist))]).reshape(-1, 2)
    margins = margins.cpu().numpy()
    fails = (gaps[:, 0] > float(limits["rank_gap"])) | (gaps[:, 1] > float(limits["score_err"]))
    near = margins < margin_limit
    excused = fails & near
    kept = ~excused
    print(f"near ties (routing margin under {margin_limit:g}): {int(near.sum())} of {len(hist)} checked users; "
          f"excused {int(excused.sum())}", flush=True)
    for r in np.flatnonzero(excused):
        print(f"excused user {r}: rank_gap {gaps[r, 0]:.6g} score_err {gaps[r, 1]:.6g} margin {margins[r]:.6g}",
              flush=True)
    far = ~near
    if far.any():
        print(f"users without a near tie: rank_gap {gaps[far, 0].max():.6g} score_err {gaps[far, 1].max():.6g}; "
              f"least margin {margins.min():.6g}", flush=True)
    return {"rank_gap": float(gaps[kept, 0].max(initial=0.0)), "score_err": float(gaps[kept, 1].max(initial=0.0)),
            "excused_share": float(excused.mean()) if len(hist) else 0.0}
