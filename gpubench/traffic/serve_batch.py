"""Offline batch serving: ``recommend_batch(histories, k, exclude_seen=True,
return_scores=True)`` on batches of ``users_per_batch`` histories, back to
back from one caller (a closed loop). The batches come from a pool drawn
in set-up: lengths a fixed multiset (``history_lengths``, evenly), item ids
Zipf over the catalog. Checked: a sample of the served users, drawn from
the seed, against the reference's exact lists and scores."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from gpubench import flops, gen, program, serving_check, weights


class Traffic:
    span_name = "recommend_batch"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.cell["traffic"]
        self.k = int(p["k"])
        self.u = int(p["users_per_batch"])
        lo, hi = p["history_lengths"]
        rng = np.random.default_rng(weights.derived_seed(ctx.seed, 10))
        self.pool = [
            gen.histories(rng, self.u, cfg["num_items"], lo, hi, p["zipf_exponent"]) for _ in range(int(p["pool_batches"]))
        ]
        self.order = np.random.default_rng(weights.derived_seed(ctx.seed, 11)).permutation(len(self.pool))
        self.model = program.build(cfg, ctx.seed, ctx.cell["weights"], ctx.device)
        self.served = []
        self.batch_s = []
        self.next = 0
        self.failed = 0
        self.routes = set()

    def _serve(self, b: int):
        t = time.perf_counter()
        ids, vals = self.model.recommend_batch(self.pool[b], k=self.k, exclude_seen=True, return_scores=True)
        if self.ctx.fault == "answer":  # a planted fault: each list's last item replaced
            n = self.ctx.cfg["num_items"]
            ids = [row[:-1] + [(row[-1] + 1) % n] for row in ids]
        self.batch_s.append(time.perf_counter() - t)
        return ids, vals

    def warm(self):
        self._serve(int(self.order[-1]))

    def open_window(self):
        self.served, self.failed, self.batch_s = [], 0, []

    def step(self):
        b = int(self.order[self.next % len(self.order)])
        self.next += 1
        try:
            ids, vals = self._serve(b)
        except Exception as e:  # counted against the attempts, and fails the run
            self.failed += 1
            self.served.append((b, None, None))
            print(f"batch failed: {e!r}", flush=True)
            return
        self.served.append((b, ids, vals))
        route = program.last_route()
        if route is not None:
            self.routes.add(repr(route))

    def work(self) -> Dict:
        done = [s for s in self.served if s[1] is not None]
        return {"attempted": len(self.served), "failed": self.failed, "units": len(done),
                "users": sum(len(s[1]) for s in done), "routes": sorted(self.routes),
                "batch_s_min_median_max": [min(self.batch_s), sorted(self.batch_s)[len(self.batch_s) // 2],
                                           max(self.batch_s)] if self.batch_s else None}

    def end_to_end(self, window_s: float) -> Dict:
        return {"serve_users_per_s": self.work()["users"] / window_s}

    def reading(self) -> Dict:
        cfg = self.ctx.cfg
        done = [s for s in self.served if s[1] is not None]
        fl = sum(flops.serve_batch(cfg, [len(h) for h in self.pool[b]], cfg["num_items"]) for b, _, _ in done)
        return {"units": len(done), "users": sum(len(s[1]) for s in done), "flops": fl,
                "route": program.last_route()}

    def release(self):
        self.model = None

    def _sample(self):
        p = self.ctx.cell["traffic"]
        done = [(b, ids, vals) for b, ids, vals in self.served if ids is not None]
        pairs = [(i, r) for i, (_, ids, _) in enumerate(done) for r in range(len(ids))]
        rng = np.random.default_rng(weights.derived_seed(self.ctx.seed, 12))
        pick = [pairs[j] for j in rng.choice(len(pairs), min(int(p["check_users"]), len(pairs)), replace=False)]
        print(f"checked users {len(pick)} of {len(pairs)} served", flush=True)
        hist = [self.pool[done[i][0]][r] for i, r in pick]
        ids = [done[i][1][r] for i, r in pick]
        vals = np.stack([done[i][2][r] for i, r in pick])
        return hist, ids, vals

    def checks(self, control: bool = False) -> Dict:
        """The sample's gaps; with ``control``, those of the reference in
        TF32 put in the program's place, on the same users."""
        hist, ids, vals = self._sample()
        return serving_check.compare(self.ctx.cfg, self.ctx.seed, self.ctx.cell["weights"], self.ctx.device,
                                     hist, ids, self.k, vals, control=control)
