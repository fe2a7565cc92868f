"""Online requests: ``recommend(history, k)`` for one user a call, back to
back from one caller (a closed loop). Histories come from a pool drawn in
set-up (lengths a fixed multiset, ids Zipf); each request's latency is the
host clock from the call until its list is on the host. Checked: a sample
of the requests answered in the window, against the reference's lists."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from gpubench import flops, gen, program, serving_check, weights


class Traffic:
    span_name = "recommend"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.cell["traffic"]
        self.k = int(p["k"])
        lo, hi = p["history_lengths"]
        rng = np.random.default_rng(weights.derived_seed(ctx.seed, 20))
        self.pool = gen.histories(rng, int(p["pool_users"]), cfg["num_items"], lo, hi, p["zipf_exponent"])
        self.warm_set = [next(h for h in self.pool if len(h) == n) for n in range(lo, hi + 1)]
        self.model = program.build(cfg, ctx.seed, ctx.cell["weights"], ctx.device)
        self.answered = []
        self.next = 0
        self.failed = 0

    def _ask(self, h):
        ids = self.model.recommend(h, k=self.k)
        if self.ctx.fault == "answer":
            ids = ids[:-1] + [(ids[-1] + 1) % self.ctx.cfg["num_items"]]
        return ids

    def warm(self):
        for h in self.warm_set:  # every seen width the window meets
            self._ask(h)

    def open_window(self):
        self.answered, self.failed = [], 0

    def step(self):
        i = self.next % len(self.pool)
        self.next += 1
        rechecked = program.rechecked_users()
        t = time.perf_counter()
        try:
            ids = self._ask(self.pool[i])
        except Exception as e:
            self.failed += 1
            print(f"request failed: {e!r}", flush=True)
            ids = None
        lat = time.perf_counter() - t
        self.answered.append((i, ids, lat, program.rechecked_users() - rechecked))

    def work(self) -> Dict:
        """The window's counts and latency percentiles; ``slow``: requests
        over twice the median, and how many of them the certificate sent
        to the FP32 recheck; ``slowest``: ``(place in the window, ms,
        history length)`` of the five slowest."""
        done = [x for x in self.answered if x[1] is not None]
        lat = [x[2] for x in done]
        pct = {f"latency_ms_p{q}": float(np.percentile(lat, q)) * 1e3 for q in (50, 90, 95, 99, 100)} if lat else {}
        slow = [x for x in done if x[2] > 2 * np.median(lat)] if lat else []
        return {"attempted": len(self.answered), "failed": self.failed, "units": len(lat), **pct,
                "rechecked": sum(x[3] for x in done), "slow": len(slow), "slow_rechecked": sum(x[3] > 0 for x in slow),
                "slowest": sorted(((j, round(x[2] * 1e3, 3), len(self.pool[x[0]])) for j, x in enumerate(done)),
                                  key=lambda e: -e[1])[:5]}

    def end_to_end(self, window_s: float) -> Dict:
        """Users answered a second (every request's list on the host in the
        window, over its wall time), and the 95th percentile of the
        requests' latencies (a failed request counts as the slowest)."""
        lat = [x[2] if x[1] is not None else float("inf") for x in self.answered]
        return {
            "recommend_users_per_s": self.work()["units"] / window_s,
            "recommend_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        }

    def reading(self) -> Dict:
        cfg = self.ctx.cfg
        done = [x for x in self.answered if x[1] is not None]
        fl = sum(flops.serve_batch(cfg, [len(self.pool[x[0]])], cfg["num_items"]) for x in done)
        return {"units": len(done), "users": len(done), "flops": fl, "route": program.last_route()}

    def release(self):
        self.model = None

    def checks(self, control: bool = False) -> Dict:
        """The sample's gaps; with ``control``, those of the reference in
        TF32 put in the program's place, on the same requests."""
        p = self.ctx.cell["traffic"]
        done = [x for x in self.answered if x[1] is not None]
        rng = np.random.default_rng(weights.derived_seed(self.ctx.seed, 22))
        pick = rng.choice(len(done), min(int(p["check_users"]), len(done)), replace=False)
        hist = [self.pool[done[j][0]] for j in pick]
        ids = [done[j][1] for j in pick]
        print(f"checked requests {len(pick)} of {len(done)} answered", flush=True)
        return serving_check.compare(self.ctx.cfg, self.ctx.seed, self.ctx.cell["weights"], self.ctx.device,
                                     hist, ids, self.k, control=control)
