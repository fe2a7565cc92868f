#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sbr_rs_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sbr_rs_tpu_torch/csrc`` and drives the
LSTM serving path, one phase per printed line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build and its time;
3. each kernel against its plain PyTorch version on the card, at the serving
   shapes, with the largest error beside the stated tolerance and the median
   time of each;
4. ``recommend_batch(k=10)`` for 4096 users over a 10,000,000-item LSTM-127
   catalog (single-pass merge, launches the LSTM and score+submax+groupmax
   kernels), in users/s, checked against a plain full-catalog reference;
5. the running-merge path (1,000,000 items, 512 users, merge budget 0), which
   launches the score+groupmax kernel chunk by chunk, checked the same way;
6. one more 10M batch under ``torch.profiler`` (after the timed runs): the
   device's busy time, its idle share and the kernels that took the time.

It then prints the kernels' JSON line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
those lines. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_ITEMS = 10_000_000
N_ITEMS_MERGE = 1_000_000
USERS = 4096
USERS_MERGE = 512
SEQ_LEN = 32
DIM = 127
SERVE_CHUNK = 131072
K = 10
REF_USERS = 32

TOL_LSTM = 1e-5   # f32; the 127-term sums run in another order, |h| < 1
TOL_SCORE = 2e-5  # f32 dot of 128 terms in another order, scores of order 1
TOL_REL = 1e-5    # top-k scores against the plain reference, relative


class SmokeFailure(Exception):
    pass


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sbr_rs_tpu_torch.models import lstm
    from sbr_rs_tpu_torch.models.towers import lstm_apply
    from sbr_rs_tpu_torch.ops import _build
    from sbr_rs_tpu_torch.ops import lstm_kernels as lk
    from sbr_rs_tpu_torch.ops import topk_kernels as tk

    dev = torch.device("cuda", 0)
    # Full f32 for every plain matmul here: the references must not round
    # through TF32.
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 1: the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(
        f"phase 1 card: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True,
    )

    # -- phase 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(
        f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {_build.build_library().name}",
        flush=True,
    )

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def compare(name, got, want, tol, quiet=False):
        if got.shape != want.shape:
            raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        fg, fw = torch.isfinite(got), torch.isfinite(want)
        if not torch.equal(fg, fw) or not torch.equal(got[~fg], want[~fw]):
            raise SmokeFailure(f"{name}: the -inf positions differ")
        err = float((got[fg] - want[fg]).abs().max()) if bool(fg.any()) else 0.0
        if not quiet:
            print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.0e})", flush=True)
        if not err <= tol:
            raise SmokeFailure(f"{name}: max_abs_err {err:.3e} above {tol:.0e}")
        return err

    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}  # kernel name -> {"max_abs_err", "ms", "plain_ms"}

    def record(name, err, ms=None, plain_ms=None):
        r = report.setdefault(name, {"max_abs_err": 0.0, "ms": None, "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # -- phase 3: kernels against their plain versions ----------------------------
    print(f"phase 3 K1 lstm_fwd: U={USERS} T={SEQ_LEN} D={DIM}", flush=True)
    for coupled in (False, True):
        gates = 3 if coupled else 4
        xz = torch.randn((SEQ_LEN, USERS, gates * DIM), device=dev, generator=gen)
        w_h = torch.randn((DIM, gates * DIM), device=dev, generator=gen) * DIM**-0.5
        starts = torch.rand((SEQ_LEN, USERS, 1), device=dev, generator=gen) < 0.1
        for keep in (torch.ones_like(starts, dtype=torch.float32), (~starts).float()):
            label = f"{'coupled' if coupled else 'normal'}, {'starts' if keep.min() == 0 else 'no starts'}"
            h, c = lk.lstm_fwd(xz, w_h, keep, coupled)
            hp, cp = lk.lstm_fwd_plain(xz, w_h, keep, coupled)
            err = max(
                compare(f"hidden ({label})", h, hp, TOL_LSTM),
                compare(f"cell ({label})", c, cp, TOL_LSTM),
            )
            if not coupled and keep.min() == 1:  # the serving path's call
                ms = time_ms(lambda: lk.lstm_fwd(xz, w_h, keep, coupled))
                plain_ms = time_ms(lambda: lk.lstm_fwd_plain(xz, w_h, keep, coupled))
                print(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
                record("lstm_fwd", err, ms, plain_ms)
            else:
                record("lstm_fwd", err)
    del xz, w_h, starts, keep, h, c, hp, cp

    def check_k3(label, rows, reps, lo, n, group, timed):
        got = tk.score_groupmax(rows, reps, lo, n, group)
        want = tk._pad_to(tk.score_groupmax_plain(rows, reps, lo, n, group), got.shape[0])
        err = compare(f"K3 {label}", got, want, TOL_SCORE)
        if timed:
            ms = time_ms(lambda: tk.score_groupmax(rows, reps, lo, n, group))
            plain_ms = time_ms(lambda: tk.score_groupmax_plain(rows, reps, lo, n, group))
            print(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            return err, ms, plain_ms
        return err, None, None

    def check_k4(label, rows, reps, lo, n, sub, group, timed):
        smax, gmax = tk.score_submax_groupmax(rows, reps, lo, n, sub, group)
        ps, pg = tk.score_submax_groupmax_plain(rows, reps, lo, n, sub, group)
        err = max(
            compare(f"K4 {label} submax", smax, tk._pad_to(ps, smax.shape[0]), TOL_SCORE),
            compare(f"K4 {label} groupmax", gmax, tk._pad_to(pg, gmax.shape[0]), TOL_SCORE),
        )
        if timed:
            ms = time_ms(lambda: tk.score_submax_groupmax(rows, reps, lo, n, sub, group))
            plain_ms = time_ms(
                lambda: tk.score_submax_groupmax_plain(rows, reps, lo, n, sub, group)
            )
            print(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        return err

    print(f"phase 3 K3/K4: one serve chunk {SERVE_CHUNK} x U={USERS}, Cc={DIM + 1}", flush=True)
    rows32 = torch.randn((SERVE_CHUNK, DIM + 1), device=dev, generator=gen)
    reps = torch.randn((USERS, DIM + 1), device=dev, generator=gen) * (DIM + 1) ** -0.5
    lo_mid = 5 * SERVE_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        rows = rows32.to(dtype)
        name = str(dtype).replace("torch.", "")
        err, _, _ = check_k3(f"{name} group 128", rows, reps, lo_mid, N_ITEMS, 128, True)
        record("score_groupmax", err)
        record("score_submax_groupmax", check_k4(f"{name} 32/128", rows, reps, lo_mid, N_ITEMS, 32, 128, True))
    # The running merge's call: one chunk x 512 users (timed for the report).
    err, ms, plain_ms = check_k3(
        f"float32 group 128, U={USERS_MERGE}", rows32, reps[:USERS_MERGE].contiguous(),
        lo_mid, N_ITEMS_MERGE, 128, True,
    )
    record("score_groupmax", err, ms, plain_ms)
    # Ragged slabs: mid-catalog (lo + c < n) and past the catalog end.
    ragged = rows32[4096 : 4096 + 100_000]
    for lo, n in ((4096, N_ITEMS_MERGE), (4096, 50_000)):
        label = f"ragged c=100000 lo={lo} n={n}"
        err, _, _ = check_k3(label, ragged, reps, lo, n, 128, False)
        record("score_groupmax", err)
        record("score_submax_groupmax", check_k4(label, ragged, reps, lo, n, 32, 128, False))
    del rows32, rows, reps, ragged
    torch.cuda.empty_cache()

    # -- phase 4: the serving path at 10M items ------------------------------------
    t0 = time.perf_counter()
    model = (
        lstm.Hyperparameters(N_ITEMS, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .from_seed(42)
        .build(dev)
    )
    torch.cuda.synchronize()
    rng = np.random.default_rng(7)
    histories = [rng.integers(0, N_ITEMS, rng.integers(2, 32)).tolist() for _ in range(USERS)]
    print(
        f"phase 4 model: {N_ITEMS} items, LSTM-{DIM} Normal, f32 table, built in "
        f"{time.perf_counter() - t0:.1f} s; {USERS} histories of 2-31 items", flush=True,
    )
    table = model._params["item_table"]

    # K4 at the shape the serving path gives it (the whole catalog), on the
    # model's own table and representations; the plain version runs chunk by
    # chunk (a whole [10M, 4096] score matrix would be 164 GB).
    reps = torch.from_numpy(
        np.stack([u.user_embedding for u in model.user_representations(histories)])
    ).to(dev)
    reps_aug = torch.cat([reps, reps.new_ones((USERS, 1))], dim=1).contiguous()
    smax, gmax = tk.score_submax_groupmax(table, reps_aug, 0, N_ITEMS, 32, 128)
    err = 0.0
    for lo in range(0, N_ITEMS, SERVE_CHUNK):
        ps, pg = tk.score_submax_groupmax_plain(table[lo : lo + SERVE_CHUNK], reps_aug, lo, N_ITEMS, 32, 128)
        s0, g0 = lo // 32, lo // 128
        err = max(
            err,
            compare(f"K4 submax rows {lo}+", smax[s0 : s0 + ps.shape[0]], ps, TOL_SCORE, quiet=True),
            compare(f"K4 groupmax rows {lo}+", gmax[g0 : g0 + pg.shape[0]], pg, TOL_SCORE, quiet=True),
        )
    if not (torch.isinf(smax[-(smax.shape[0] - (N_ITEMS + 31) // 32):]).all()):
        raise SmokeFailure("K4 whole catalog: pad rows are not -inf")
    ms = time_ms(lambda: tk.score_submax_groupmax(table, reps_aug, 0, N_ITEMS, 32, 128), reps=3)

    def plain_whole():
        for lo in range(0, N_ITEMS, SERVE_CHUNK):
            tk.score_submax_groupmax_plain(table[lo : lo + SERVE_CHUNK], reps_aug, lo, N_ITEMS, 32, 128)

    plain_ms = time_ms(plain_whole, reps=3)
    print(
        f"  K4 whole catalog {N_ITEMS} x U={USERS}, sub 32 / group 128: max_abs_err {err:.3e} "
        f"(tol {TOL_SCORE:.0e}); kernel {ms:.1f} ms, plain (chunked) {plain_ms:.1f} ms", flush=True,
    )
    record("score_submax_groupmax", err, ms, plain_ms)
    del reps, reps_aug, smax, gmax
    torch.cuda.empty_cache()

    # The main path: every launch counter from 0, then the entry points.
    counters = {
        "lstm_fwd": lk.lstm_fwd,
        "score_groupmax": tk.score_groupmax,
        "score_submax_groupmax": tk.score_submax_groupmax,
    }
    for fn in counters.values():
        fn.launches = 0
    model.recommend_batch(histories, k=K)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ids, vals = model.recommend_batch(histories, k=K, return_scores=True)
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    print(
        f"phase 4 recommend_batch k={K}: {USERS / t_med:.1f} users/s (median of 3: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per batch of {USERS})", flush=True,
    )
    model_merge = (
        lstm.Hyperparameters(N_ITEMS_MERGE, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .from_seed(42)
        .build(dev)
    )
    model_merge._MERGE_BUFFER_BYTES = 0  # forces the running per-chunk merge
    rng_m = np.random.default_rng(8)
    hist_m = [rng_m.integers(0, N_ITEMS_MERGE, rng_m.integers(2, 32)).tolist() for _ in range(USERS_MERGE)]
    t0 = time.perf_counter()
    ids_m, vals_m = model_merge.recommend_batch(hist_m, k=K, return_scores=True)
    t_m = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"phase 5 running merge: {N_ITEMS_MERGE} items, U={USERS_MERGE}: {t_m * 1e3:.1f} ms (one call)", flush=True)
    print(f"launches on the serving path: {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise SmokeFailure(f"the serving path never launched {name}")

    # -- checks against the plain reference ------------------------------------------
    check_lists("phase 4", ids, histories, N_ITEMS)
    check_against_reference(
        "phase 4", model, histories[:REF_USERS], ids[:REF_USERS], vals[:REF_USERS], lstm_apply, torch
    )
    check_lists("phase 5", ids_m, hist_m, N_ITEMS_MERGE)
    check_against_reference("phase 5", model_merge, hist_m, ids_m, vals_m, lstm_apply, torch)

    # -- phase 6: where a batch's device time goes (a separate traced run) ----------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.recommend_batch(histories, k=K)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    print(
        f"phase 6 profile, one batch at {N_ITEMS} items: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}", flush=True,
    )
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:3d}x {e.key[:100]}")

    kernels = []
    sources = {
        "lstm_fwd": ("sbr_rs_tpu_torch/csrc/lstm_fwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:49"),
        "score_groupmax": ("sbr_rs_tpu_torch/csrc/score_groupmax.cu", "sbr_rs_tpu/ops/pallas_topk.py:108"),
        "score_submax_groupmax": ("sbr_rs_tpu_torch/csrc/score_groupmax.cu", "sbr_rs_tpu/ops/pallas_topk.py:130"),
    }
    for name, (source, replaces) in sources.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


def check_lists(phase, ids, histories, n):
    """Every list: k distinct ids inside the catalog, none from its history."""
    for u, (row, h) in enumerate(zip(ids, histories)):
        if len(row) != K or len(set(row)) != K:
            raise SmokeFailure(f"{phase}: user {u} got {row}, not {K} distinct ids")
        if min(row) < 0 or max(row) >= n:
            raise SmokeFailure(f"{phase}: user {u} got ids outside [0, {n})")
        if set(row) & set(h):
            raise SmokeFailure(f"{phase}: user {u} was recommended an item it has seen")
    print(f"  {phase}: {len(ids)} lists of {K} distinct unseen ids in [0, {n})", flush=True)


def check_against_reference(phase, model, histories, ids, vals, lstm_apply, torch):
    """The same users through a plain reference: the plain LSTM loop on the
    same parameters, one torch.matmul per catalog chunk, seen items masked,
    torch.topk. Scores agree within TOL_REL relative; ids agree except where
    the reference's own scores tie within that tolerance."""
    params = model._params
    table = params["item_table"]
    n, t = table.shape[0], model.hyper._max_sequence_length
    dev = table.device
    u = len(histories)
    inputs = np.zeros((u, t), dtype=np.int64)
    last = np.zeros(u, dtype=np.int64)
    for i, h in enumerate(histories):
        h = h[-t:] or [0]
        inputs[i, : len(h)] = h
        last[i] = len(h) - 1
    emb = table[torch.from_numpy(inputs).to(dev)][:, :, :-1].float()
    hidden = lstm_apply(params["tower"], emb, coupled=False)
    reps = hidden[torch.arange(u, device=dev), torch.from_numpy(last).to(dev)]
    scores = torch.cat([
        reps @ table[lo : lo + SERVE_CHUNK, :-1].float().T + table[lo : lo + SERVE_CHUNK, -1].float()
        for lo in range(0, n, SERVE_CHUNK)
    ], dim=1)
    for i, h in enumerate(histories):
        scores[i, torch.tensor(sorted(set(h)), device=dev)] = float("-inf")
    ref_v, ref_i = torch.topk(scores, K + 1, dim=1)
    ref_v, ref_i = ref_v.cpu().numpy(), ref_i.cpu().numpy()
    got_i = np.asarray(ids)
    got_v = np.asarray(vals)
    bound = TOL_REL * np.abs(ref_v[:, :K]) + 1e-12
    if not np.all(np.abs(got_v - ref_v[:, :K]) <= bound):
        worst = float(np.max(np.abs(got_v - ref_v[:, :K]) / np.abs(ref_v[:, :K])))
        raise SmokeFailure(f"{phase}: scores differ from the reference (worst relative {worst:.2e})")
    own = scores.gather(1, torch.from_numpy(got_i).to(dev)).cpu().numpy()
    if not np.all(np.abs(own - got_v) <= bound):
        raise SmokeFailure(f"{phase}: returned scores are not the items' reference scores")
    gap = np.abs(np.diff(ref_v, axis=1)) <= TOL_REL * np.abs(ref_v[:, 1:])
    tied = np.zeros((u, K), dtype=bool)
    tied |= gap[:, :K]
    tied[:, 1:] |= gap[:, : K - 1]
    mism = (got_i != ref_i[:, :K]) & ~tied
    if mism.any():
        raise SmokeFailure(f"{phase}: ids differ from the reference at {int(mism.sum())} untied ranks")
    print(
        f"  {phase}: {u} users agree with the plain reference (scores within "
        f"{TOL_REL:.0e} relative; {int(tied.sum())} tied ranks)", flush=True,
    )


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
