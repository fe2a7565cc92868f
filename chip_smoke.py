#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sbr_rs_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sbr_rs_tpu_torch/csrc`` and drives the
LSTM serving and training paths, one phase per printed line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build and its time;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving and training paths, with the largest error beside the
   stated tolerance and the median time of each: the LSTM forward (K1), the
   LSTM backward (K2) and its dW_h reduction, the score + group-max kernels;
4. ``recommend_batch(k=10)`` for 4096 users over a 10,000,000-item LSTM-127
   catalog (single-pass merge, launches the LSTM and score+submax+groupmax
   kernels), in users/s, checked against a plain full-catalog reference;
5. the running-merge path (1,000,000 items, 512 users, merge budget 0), which
   launches the score+groupmax kernel chunk by chunk, checked the same way;
6. one more 10M batch under ``torch.profiler`` (after the timed runs): the
   device's busy time, its idle share and the kernels that took the time;
7. one training step over the kernel tower (K1 + K2) against the same step
   over the plain PyTorch tower (autograd through the time loop), same
   parameters, batch and candidates, for both fit configurations below;
8. ``fit`` at full width, the ``ml1m`` configuration of
   ``benches/large_scale.py``: ML-1M-shaped synthetic data (6040 users x
   3706 items x 165), Coupled LSTM-128, T=128, Hinge, Adam, packed, batch
   256, one epoch; a warm-up fit, a timed fit in examples/s, and one more
   fit under ``torch.profiler``;
9. ``fit`` on the ``bench.py`` configuration over ML-100K-shaped synthetic
   data (943 x 1682 x 106, user split 0.2): Normal LSTM-32, T=32, WARP,
   Adagrad, packed, batch 256, 10 epochs, in examples/s (a fresh fit, then
   the range over five continued fits), with a falling loss; one more fit
   under ``torch.profiler``; then ``recommend_batch(k=10)`` for 64 training
   histories.

It then prints the kernels' JSON line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
those lines. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import functools
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
TOL_DXZ = 1e-5    # K2 dxz: f32 sums of D (and G*D) terms in another order
TOL_DWH = 1e-4    # K2 dW_h relative to max|dW_h|: T*B products in another order
# A training step, kernel tower against plain tower: the loss (relative);
# the updated table and tower (rtol, atol), loose because Adagrad's
# g / sqrt(g^2 + eps) amplifies association noise on nearly cancelling rows.
TOL_STEP_LOSS = 1e-5
TOL_STEP_RTOL, TOL_STEP_ATOL = 2e-4, 1e-3
# Below this gradient magnitude a first Adam/Adagrad step is ill-conditioned:
# lr * g / (|g| + eps) moves by a large share of lr when g moves by rounding.
G_FLOOR = 1e-5

# (T, B, D, variants) of K2's checks: the ml1m fit, the bench.py fit, and an
# odd D whose w_h (Normal) is beyond a block's shared memory.
K2_SHAPES = [(128, 256, 128, (True, False)), (32, 256, 32, (False, True)), (32, 4096, 127, (False,))]
K2_TIMED = (128, 256, 128, True, True)  # the ml1m fit's call: Coupled, packed
BENCH_REPEATS = 5  # continued bench.py-config fits timed, for their spread


class SmokeFailure(Exception):
    pass


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sbr_rs_tpu_torch import data as sbr_data
    from sbr_rs_tpu_torch import datasets
    from sbr_rs_tpu_torch.models import Loss, Optimizer, engine, lstm
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

    def compare_rel(name, got, want, tol):
        """Largest error relative to max|want|; returns the absolute one."""
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        print(f"  {name}: max_abs_err {err:.3e}, relative to max|want| {rel:.3e} (tol {tol:.0e})", flush=True)
        if not rel <= tol:
            raise SmokeFailure(f"{name}: relative error {rel:.3e} above {tol:.0e}")
        return err

    print("phase 3 K2 lstm_bwd and its dW_h reduction, at the training shapes", flush=True)
    for t_len, b, d, variants in K2_SHAPES:
        for coupled in variants:
            gates = 3 if coupled else 4
            xz = torch.randn((t_len, b, gates * d), device=dev, generator=gen)
            w_h = torch.randn((d, gates * d), device=dev, generator=gen) * d**-0.5
            g = torch.randn((t_len, b, d), device=dev, generator=gen)
            starts = torch.rand((t_len, b, 1), device=dev, generator=gen) < 0.1
            for with_starts in (False, True):
                keep = (~starts).float() if with_starts else torch.ones_like(starts, dtype=torch.float32)
                label = (
                    f"T={t_len} B={b} D={d} {'coupled' if coupled else 'normal'}, "
                    f"{'starts' if with_starts else 'no starts'}"
                )
                h, c = lk.lstm_fwd(xz, w_h, keep, coupled)
                hp, cp = lk.lstm_fwd_plain(xz, w_h, keep, coupled)
                record("lstm_fwd", max(
                    compare(f"K1 hidden ({label})", h, hp, TOL_LSTM, quiet=True),
                    compare(f"K1 cell ({label})", c, cp, TOL_LSTM, quiet=True),
                ))
                dxz, dwh = lk.lstm_bwd(xz, w_h, h, c, g, keep, coupled)
                pdxz, pdwh = lk.lstm_bwd_plain(xz, w_h, h, c, g, keep, coupled)
                err = compare(f"K2 dxz ({label})", dxz, pdxz, TOL_DXZ)
                err_w = compare_rel(f"K2 dW_h ({label})", dwh, pdwh, TOL_DWH)
                err_w = max(err_w, compare_rel(
                    "  dW_h reduction alone", lk.lstm_bwd_dwh(h, keep, dxz),
                    lk.lstm_bwd_dwh_plain(h, keep, dxz), TOL_DWH,
                ))
                ms = time_ms(lambda: lk.lstm_bwd(xz, w_h, h, c, g, keep, coupled))
                plain_ms = time_ms(lambda: lk.lstm_bwd_plain(xz, w_h, h, c, g, keep, coupled))
                red_ms = time_ms(lambda: lk.lstm_bwd_dwh(h, keep, dxz))
                red_plain_ms = time_ms(lambda: lk.lstm_bwd_dwh_plain(h, keep, dxz))
                fwd_ms = time_ms(lambda: lk.lstm_fwd(xz, w_h, keep, coupled))
                print(
                    f"  time: K2 {ms:.3f} ms (plain {plain_ms:.3f}), of which dW_h reduction "
                    f"{red_ms:.3f} ms (plain matmul {red_plain_ms:.3f}); K1 at this shape {fwd_ms:.3f} ms",
                    flush=True,
                )
                timed = (t_len, b, d, coupled, with_starts) == K2_TIMED
                record("lstm_bwd", err, *((ms, plain_ms) if timed else ()))
                record("lstm_bwd_dwh", err_w, *((red_ms, red_plain_ms) if timed else ()))
    del xz, w_h, g, starts, keep, h, c, hp, cp, dxz, dwh, pdxz, pdwh
    torch.cuda.empty_cache()

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
        "lstm_bwd": lk.lstm_bwd,
        "lstm_bwd_dwh": lk.lstm_bwd_dwh,
        "score_groupmax": tk.score_groupmax,
        "score_submax_groupmax": tk.score_submax_groupmax,
    }
    serving_kernels = ("lstm_fwd", "score_groupmax", "score_submax_groupmax")
    training_kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_dwh")
    launches = dict.fromkeys(counters, 0)  # summed over the main-path runs

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters(path, kernels):
        got = {name: counters[name].launches for name in counters}
        print(f"launches on the {path}: {got}", flush=True)
        for name in kernels:
            if got[name] <= 0:
                raise SmokeFailure(f"the {path} never launched {name}")
        for name, count in got.items():
            launches[name] += count

    zero_counters()
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
    print(f"phase 5 running merge: {N_ITEMS_MERGE} items, U={USERS_MERGE}: {t_m * 1e3:.1f} ms (one call)", flush=True)
    read_counters("serving path", serving_kernels)

    # -- checks against the plain reference ------------------------------------------
    check_lists("phase 4", ids, histories, N_ITEMS)
    check_against_reference(
        "phase 4", model, histories[:REF_USERS], ids[:REF_USERS], vals[:REF_USERS], lstm_apply, torch
    )
    check_lists("phase 5", ids_m, hist_m, N_ITEMS_MERGE)
    check_against_reference("phase 5", model_merge, hist_m, ids_m, vals_m, lstm_apply, torch)

    # -- phase 6: where a batch's device time goes (a separate traced run) ----------
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, fn, top):
        """Run ``fn`` once under ``torch.profiler`` and print its wall time,
        the device's busy time (sum of kernel self times), the idle share,
        the kernel launches and the ``top`` kernels by device time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        on_device = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
        ]
        busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        print(
            f"{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in on_device)} kernel launches",
            flush=True,
        )
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:100]}")

    profiled(
        f"phase 6 profile, one batch at {N_ITEMS} items",
        lambda: model.recommend_batch(histories, k=K), top=8,
    )
    del model, model_merge, table
    torch.cuda.empty_cache()

    # -- the training path -------------------------------------------------------------
    def ml1m_model():
        return (
            lstm.Hyperparameters(3706, 128)
            .embedding_dim(128)
            .learning_rate(0.05)
            .loss(Loss.HINGE)
            .optimizer(Optimizer.ADAM)
            .lstm_variant(lstm.LSTMVariant.COUPLED)
            .num_epochs(1)
            .batch_size(256)
            .packed(True)
            .from_seed(0)
            .build(dev)
        )

    def bench_model():
        return (
            lstm.Hyperparameters(1682, 32)
            .embedding_dim(32)
            .learning_rate(0.16)
            .l2_penalty(4e-4)
            .lstm_variant(lstm.LSTMVariant.NORMAL)
            .loss(Loss.WARP)
            .optimizer(Optimizer.ADAGRAD)
            .num_epochs(10)
            .batch_size(256)
            .packed(True)
            .from_seed(42)
            .build(dev)
        )

    t0 = time.perf_counter()
    ml1m_data = datasets.synthetic_interactions(6040, 3706, 165, rng=0).to_compressed()
    bench_raw = datasets.synthetic_interactions(943, 1682, 106, rng=0)
    bench_train, _ = sbr_data.user_based_split(bench_raw, np.random.default_rng(42), 0.2)
    bench_data = bench_train.to_compressed()
    print(
        f"training data: ml1m-shaped {len(ml1m_data)} interactions, bench-shaped "
        f"{len(bench_data)} training interactions, made in {time.perf_counter() - t0:.1f} s", flush=True,
    )

    # -- phase 7: one step, kernel tower against plain tower -------------------------------
    def step_grad(state):
        """The gradient one step from zero state used, read back from the
        state: Adam's m = (1 - b1) g, Adagrad's acc = g^2 (magnitude)."""
        if "m" in state:
            return state["m"].float() / 0.1
        return state["acc"].float().sqrt()

    def check_update(name, got, want, s_got, s_want):
        """The gradients agree everywhere (1e-5 + 2e-4 |g|). The updated
        values agree within TOL_STEP_RTOL/ATOL wherever |g| >= G_FLOOR; below
        it the first step's lr * g / (|g| + eps) turns the rounding noise of a
        nearly cancelled gradient into a different update, and those entries
        are only counted. Returns (max diff on checked entries, count
        excluded)."""
        got, want = got.float(), want.float()
        g_got, g_want = step_grad(s_got), step_grad(s_want)
        gbad = (g_got - g_want).abs() > 1e-5 + 2e-4 * g_want.abs()
        if bool(gbad.any()):
            raise SmokeFailure(
                f"{name}: {int(gbad.sum())} gradient entries differ "
                f"(max diff {float((g_got - g_want).abs().max()):.3e})"
            )
        cond = g_want.abs() >= G_FLOOR
        diff = (got - want).abs()
        bad = cond & (diff > TOL_STEP_ATOL + TOL_STEP_RTOL * want.abs())
        if bool(bad.any()):
            raise SmokeFailure(
                f"{name}: {int(bad.sum())} entries beyond rtol/atol (max diff {float(diff[bad].max()):.3e})"
            )
        return float(diff[cond].max()) if bool(cond.any()) else 0.0, int((~cond & (diff > TOL_STEP_ATOL)).sum())

    for label, make, mat in (("ml1m", ml1m_model, ml1m_data), ("bench", bench_model, bench_data)):
        model = make()
        hp = model.hyper
        stream, mask, starts, n, _ = model._windows(mat)
        rows = torch.arange(min(hp._batch_size, n), device=dev)
        batch = {"stream": stream[rows], "mask": mask[rows], "starts": starts[rows]}
        k_cand = 5 if hp._loss == Loss.WARP else 1
        cand = torch.randint(0, hp._num_items, (len(rows), hp._max_sequence_length, k_cand),
                             generator=gen, device=dev)
        cfg = model._engine_config()
        towers_ = {
            "kernel": model._tower_fn(),
            "plain": functools.partial(lstm_apply, coupled=model._coupled()),
        }
        out = {}
        for name, tower in towers_.items():
            params = {
                "item_table": model._params["item_table"].clone(),
                "tower": {k: v.clone() for k, v in model._params["tower"].items()},
            }
            state = engine.init_opt_state(hp._optimizer, params)
            step = engine.make_train_step(cfg, tower)
            params, state, loss = step(params, state, batch, cand)
            # Copies of the one-step result: the timing below steps on in place.
            result = {
                "item_table": (params["item_table"].clone(), {k: v.clone() for k, v in state["item_table"].items()}),
                **{k: (v.clone(), {n_: s_.clone() for n_, s_ in state["tower"][k].items()})
                   for k, v in params["tower"].items()},
            }
            ms = time_ms(lambda: step(params, state, batch, cand), reps=3)
            out[name] = (result, float(loss), ms)
        (rk, loss_k, msk), (rp, loss_p, msp) = out["kernel"], out["plain"]
        if not abs(loss_k - loss_p) <= TOL_STEP_LOSS * abs(loss_p):
            raise SmokeFailure(f"phase 7 {label}: loss {loss_k} against plain {loss_p}")
        checked = {
            k: check_update(f"phase 7 {label} {k}", rk[k][0], rp[k][0], rk[k][1], rp[k][1]) for k in rk
        }
        print(
            f"phase 7 step {label}: loss {loss_k:.6f} vs plain tower {loss_p:.6f}; gradients agree; "
            f"updated values max diff {max(e for e, _ in checked.values()):.3e} where |g| >= {G_FLOOR:.0e} "
            f"(rtol {TOL_STEP_RTOL:.0e}, atol {TOL_STEP_ATOL:.0e}), "
            f"{sum(c for _, c in checked.values())} entries below it beyond atol; step "
            f"{msk:.2f} ms, plain tower {msp:.2f} ms", flush=True,
        )
        del model, out, rk, rp, params, state
    torch.cuda.empty_cache()

    # -- phase 8: fit at full width, the ml1m configuration ---------------------------------
    model = ml1m_model()
    warm = model.fit(ml1m_data)
    wall_warm = model.history.wall_s
    zero_counters()
    loss = model.fit(ml1m_data)
    h = model.history
    read_counters("ml1m fit", training_kernels)
    if not np.isfinite(loss):
        raise SmokeFailure(f"phase 8: loss {loss}")
    print(
        f"phase 8 fit ml1m (Coupled LSTM-128, T=128, Hinge/Adam, packed, batch 256): "
        f"{h.examples_per_sec:.1f} examples/s ({h.examples_per_epoch} examples per epoch, "
        f"{h.wall_s:.3f} s; warm-up fit {wall_warm:.3f} s), loss {loss:.6f} (warm-up {warm:.6f})",
        flush=True,
    )
    profiled("phase 8 profile, one ml1m fit", lambda: model.fit(ml1m_data), top=12)
    del model
    torch.cuda.empty_cache()

    # -- phase 9: the bench.py configuration, then serving from it ----------------------------
    model = bench_model()
    first = model.fit(bench_data)
    h0 = model.history
    if not (np.isfinite(first) and h0.epoch_losses[-1] < h0.epoch_losses[0]):
        raise SmokeFailure(f"phase 9: epoch losses {h0.epoch_losses.tolist()} do not fall")
    zero_counters()
    again = model.fit(bench_data)
    read_counters("bench fit", training_kernels)
    continued = [model.history]
    for _ in range(BENCH_REPEATS - 1):
        again = model.fit(bench_data)
        continued.append(model.history)
    if not np.isfinite(again):
        raise SmokeFailure(f"phase 9: loss {again}")
    rates = sorted(h.examples_per_sec for h in continued)
    print(
        f"phase 9 fit bench (Normal LSTM-32, T=32, WARP/Adagrad, packed, batch 256, 10 epochs): "
        f"{h0.examples_per_sec:.1f} examples/s fresh ({h0.wall_s:.3f} s); {len(rates)} continued fits "
        f"{rates[0]:.1f} .. {rates[-1]:.1f} examples/s (median {statistics.median(rates):.1f}); "
        f"{h0.examples_per_epoch} examples per epoch; epoch losses {h0.epoch_losses[0]:.1f} -> "
        f"{h0.epoch_losses[-1]:.1f}, loss {first:.6f}",
        flush=True,
    )
    profiled("phase 9 profile, one bench fit", lambda: model.fit(bench_data), top=12)
    ptr, items = bench_data.user_pointers, bench_data.item_ids
    hist_t = [items[ptr[u] : ptr[u + 1]].tolist() for u in range(len(ptr) - 1) if ptr[u + 1] > ptr[u]][:64]
    check_lists("phase 9 recommend_batch", model.recommend_batch(hist_t, k=K), hist_t, 1682)

    kernels = []
    sources = {
        "lstm_fwd": ("sbr_rs_tpu_torch/csrc/lstm_fwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:49"),
        "lstm_bwd": ("sbr_rs_tpu_torch/csrc/lstm_bwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:82"),
        "lstm_bwd_dwh": ("sbr_rs_tpu_torch/csrc/lstm_bwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:82"),
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
