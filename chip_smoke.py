#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sbr_rs_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sbr_rs_tpu_torch/csrc`` and drives the
LSTM serving, evaluation and training paths, then those of the EWMA, GRU and
attention families, one phase per printed line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build and its time;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving and training paths, with the largest error beside the
   stated tolerance and the median time of each: the LSTM forward (K1: the
   serving shape, the ml1m and fit-10M-sparse fits' shapes, D = 512 on the
   wide (L2) route; each shape's route, cluster size and rows printed, two
   calls bit-equal; cuDNN's LSTM timed beside it where it computes the same
   function, Normal without resets), the LSTM backward (K2, the same checks,
   cuDNN's forward + backward beside the port's tower step at fit-bench's
   shape) and its dW_h reduction (3xTF32 on the tensor cores: two
   calls bit-equal, one device launch a call, device time beside torch.mm's;
   zeros at T=1), the score + group-max kernels K3 and K4 on both routes:
   3xTF32 (each maximum within the certificate's eps of the plain one and
   within TOL_SCORE per 128 terms; K3's maxima equal to K4's group maxima
   bit for bit, with the reps split in the call or once beforehand) and
   FP32 (within TOL_SCORE; K3's maxima equal to the FP32 K4's bit for bit),
   f32 and bf16 rows, cc = 33, 128, 301 and 512, ragged slabs, both K3
   routes timed at U=512 and U=4096; the 3xTF32 error on all-positive rows
   and reps, where no cancellation hides it, against the stated bound, for
   K3 and K4; the score + rank
   count kernel (K5, 3xTF32: counts may differ only by rows whose score lies
   within the tolerance of the target), and the
   training step's row kernels at the sparse step's shapes: the row gather
   (P1) and row read-modify-write (P2) on 33,024 sorted unique rows of a
   10,000,000 x 128 f32 and a 20,000,000 x 128 bf16 table (bit for bit,
   with the dropped sentinel interleaved for P2), WARP's candidate scores
   with the table in shared memory (P3, staged by one bulk copy a block:
   fit-bench's 1682 x 33 table in f32 and bf16, byte sizes that are not a
   multiple of 16, a table that does not start on a 16-byte boundary, timed
   beside P4 on the same inputs) and read from device memory
   (P4, the same tables, the probe's 1688 x 128 table and the 10M/20M
   tables at 16,384 positions x 5), within 1e-5 relative;
3b. K3's and K4's two 3xTF32 tiles (``ops/topk_kernels.py submax_tile``:
   table rows on the wgmma's N for narrow rows, on its M past that tile's
   shared memory), each call's tile checked by its counter, against the
   plain version within the certificate's eps, K3's group maxima equal to
   K4's bit for bit: f32 and bf16 rows at cc = 2, 8, 17, 33, 40, 41, the
   last rows-on-N width and the next, (sub, group) = (8, 16), (16, 128),
   (32, 128), U = 1, 127, 129 and 4096, slabs off a 16-byte boundary,
   ragged ends, lo > 0 with the catalog ending inside the call; the error
   on all-positive inputs against the bound; K4 timed at 50M x 33 (U =
   4096 and 1) on both tiles and at 10M x 128 x 4096;
4. the 3xTF32 K4 at the serving shape (10M x 4096) against its plain version
   and timed beside the FP32 K4 on the same inputs; then ``recommend_batch(
   k=10)`` for 4096 users over a 10,000,000-item LSTM-127 catalog
   (single-pass merge: the LSTM kernel, the 3xTF32 K4 and the certificate),
   in users/s, with the users the certificate sent back to the FP32 K4,
   checked against a plain full-catalog reference on 256 users, and one
   batch served with the caller's ``allow_tf32`` True (the same ids, the
   flag left True); then on each side of the serving budgets: the card's,
   derived from its free memory at each call (the default), and the JAX
   package's constants fixed on the model, each side's budgets, route and
   users/s, the two sides' lists alike; a third side, the card's budgets
   with phase 2's fixed at its constant (the route is the same on all
   three), and the host time of one reading of the card's memory;
5. the running-merge path (1,000,000 items, 512 users, merge budget 0), which
   launches the 3xTF32 K3 chunk by chunk and certifies each user, checked
   the same way, with the users sent to the FP32 K3;
5b. a 1,000,000-item catalog of 100 copies of 10,000 items (every copy keeps
   its item's row): every user's top-10 ties with its certificate's
   threshold, so each one is rescored through the FP32 K4; checked the same
   way;
5c. the same catalog through the running merge (merge budget 0): every user
   goes to the FP32 K3; checked the same way;
5d. serve-50M-merge: the serving model at 50,000,000 items (a 25.6 GB f32
   table), 4096 users, on each side of the budgets: the card's take the
   single pass (K4; the card's free memory printed before and after
   ``empty_cache`` and after the build), the constants the running merge
   (382 chunk calls of K3 a batch); users/s, one profiled batch and the
   launches of each side, the two sides' lists alike, checked against the
   plain reference (a running top-11 per catalog chunk) on 256 users; the
   10M model is freed first and built again after 5e;
5e. serve-20M-bf16, ``benches/serving.py``'s ``items20m_bf16``: the same
   model at 20,000,000 items with a bf16 table (5.12 GB), 4096 users, on
   each side of the budgets as in 5d (K4 on both, one profiled batch
   each), checked the same way;
   then one JSON line ``{"serving_budgets": ...}``: each cell's budgets,
   route and users/s on each side;
6. one more 10M batch under ``torch.profiler`` (after the timed runs): the
   device's busy time, its idle share and the kernels that took the time;
6b. ``evaluation.mrr_score`` on the same 10M-item model for 512 and 4096
   held-out users (the fused counter: one K5 launch per user batch), in
   µs per user, one profiled 4096-user call, K5 at that shape against its
   plain version (chunked), and 64 users' ranks against the per-user
   ``predict`` loop;
6c. the fused counter (K5) against the chunked counter and the per-user
   loop on a 200,000-item model (four chunks, a clamped tail), with
   repeated seen items and held-out items already seen;
7. one training step over the kernel tower (K1 + K2) against the same step
   over the plain PyTorch tower (autograd through the time loop), same
   parameters, batch and candidates, for both fit configurations below,
   with WARP's selections under the two towers compared (a flip is allowed
   only where a candidate sits within 1e-4 of the margin);
7b. one sparse step against one dense step of the port, same parameters,
   batch and candidates: the bench configuration (Adagrad, f32 table) and
   the ml1m configuration with a bf16 table (Adam, bf16 state);
8. ``fit`` at full width, the ``ml1m`` configuration of
   ``benches/large_scale.py``: ML-1M-shaped synthetic data (6040 users x
   3706 items x 165), Coupled LSTM-128, T=128, Hinge, Adam, packed, batch
   256, one epoch; a warm-up fit, a timed fit in examples/s, one more fit
   under ``torch.profiler``, and two fresh fits from one seed whose tables
   and towers must be equal bit for bit (the dense table step sums in a
   fixed order);
9. ``fit`` on the ``bench.py`` configuration over ML-100K-shaped synthetic
   data (943 x 1682 x 106, user split 0.2): Normal LSTM-32, T=32, WARP,
   Adagrad, packed, batch 256, 10 epochs, in examples/s (a fresh fit, then
   the range over five continued fits), with a falling loss; one more fit
   under ``torch.profiler``; then ``recommend_batch(k=10)`` for 64 training
   histories, and MRR, hit rate@10 and NDCG@10 on the held-out users (a
   single chunk: the chunked counter), above the untrained model's MRR;
10. fit-10M-sparse, the ``items10m`` configuration of
   ``benches/large_scale.py``: ``synthetic_interactions(20_000, 10_000_000,
   50)``, LSTM-127 (the bench's default variant, Coupled), T=64, WARP,
   Adagrad, lr 0.1, packed, batch 256, sparse updates, one epoch, a
   5.12 GB f32 table and 5.12 GB of state: a warm-up fit, a timed fit in
   examples/s, a profiled fit, then ``mrr_score`` of the trained model on
   512 held-out users, the MRR difference between the fused counter (K5)
   and the plain chunked counter on those users, and 64 users' ranks
   against the per-user loop;
11. fit-20M-bf16, the ``items20m_bf16`` configuration: the same at
   20,000,000 items with a bf16 table and bf16 state: a warm-up fit and a
   timed fit;
12-14. the EWMA (12), GRU (13) and causal-attention (14) families, whose
   towers are plain PyTorch, each through its entry points at full width:
   one training step on the card against the same step on the CPU (the
   same numpy parameters, batch and candidates; the criterion and the tuned
   WARP configurations; loss, gradients, updated values and WARP flips as
   in phase 7); the criterion ``fit`` cell of ``benches/benchmark.py``
   (dim 32, T=128, Hinge, Adagrad, 3 epochs, on a 10,000-interaction
   sample of the ML-100K-shaped data: two fresh fits from one seed bit for
   bit, the second the warm-up of 10 timed fits (GRU 2), and a profiled
   window of 10 steps (GRU 3) with its launches a step); the family's tuned
   WARP configuration of ``tests/test_integration_ml100k.py`` on phase 9's
   data, 4 epochs (GRU 2; the tests run 40, 40 and 20): a falling loss,
   ``recommend_batch(k=10)`` for 64 histories served twice alike, MRR / hit
   rate@10 / NDCG@10 on the held-out users above the untrained model's MRR,
   a profiled window of steps (attention also with dropout 0.2, which must
   draw from its dropout generator); serve-10M's shape (dim 127, T=32,
   10,000,000 items, 4096 users: users/s, the users the certificate
   rechecked, a profiled batch, 256 users against the plain reference with
   the family's tower, itself plain PyTorch); and eval-10M-512 (µs per
   user, a profiled call, 64 users' ranks against the per-user loop). Each
   path's counters must show P1 and P2 (fits), P3 (WARP fits), K4
   (serving) and K5 (evaluation) at work, and no launch of K1 or K2;
15a. checkpoints: phase 9's fit-bench model, trained, saved on the card and
   loaded: ``recommend_batch`` ids and scores and the three metrics equal
   bit for bit, one more ``fit`` from each (the loaded one counted as a
   path: K1, K2, P1, P3) with parameters bit-equal (the generators
   restored), and the same directory loaded on the CPU (representations
   within TOL_LSTM);
15b. ckpt-10M: serve-10M's model (5.12 GB f32 table, flax's 5 chunks), the
   free disk first (the catalog cut to what it holds, at least 2 chunks),
   saved and loaded with their seconds, GB/s, busy seconds of the
   device->host copy, the hash and the write (or read), and the host's
   peak RSS above its level before each call; then ``recommend_batch`` for
   the 4096 serving users and ``mrr_score`` for eval-10M-512's users from
   the loaded model (both counted as paths), bit-equal and equal;
15c. a 5,000,000 x 128 bf16 table (1.28 GB, 2 chunks) round-tripped bit
   for bit; the EWMA, GRU and attention criterion models round-tripped
   with their representations bit-equal; whether ``msgpack`` is importable
   (for information: nothing needs it);
16. one serve-10M batch under ``utils.metrics.trace``, in a process of its
   own (``trace_serve_batch``): the trace file must name K4's and K1's CUDA
   symbols;
17. ``examples/torch_quickstart.py --epochs 1`` in a subprocess on the card;
18a. the mesh at world size 1: ``parallel.initialize(backend="nccl")`` with a
   one-rank TCP rendezvous, and a (1, 1) mesh fit-bench fit bit-equal to
   the mesh-less fit (losses and every parameter);
18b. four ranks on the one card over gloo (``backend="gloo"``, the caller's
   choice: NCCL refuses two ranks on one device; gloo copies the CUDA
   tensors of its collectives through the host), a (data=2, model=2) mesh
   (``scripts/torch_multiprocess_fit.py``): fit-10M-sparse-mesh (phase 10's
   configuration, each rank a 5,000,000-row slab of the table and its
   Adagrad state) and the same with Hinge, each equal bit for bit (losses,
   sha256 of each slab and of the tower) to the world-size-1 fit on the
   same draws that runs each batch as the data axis's two shares and sums
   them without a collective; the replicas bit-equal; WARP's epoch loss
   within 1e-4 of the plain world-size-1 fit's, and both fits' distance
   from it printed; the ranks' sharded save loaded at world size 1 equal to
   the fitted model; in examples/s with the host seconds, calls and bytes
   of rank 0's collectives; eval-10M-512-mesh (K5 on each slab) against the
   world-size-1 ranks of the loaded model except at near-ties; then two
   ranks: a (1, 2) fit-10M-sparse fit (the row-sharded step alone) whose
   table and tower equal the world-size-1 fit's bit for bit (sha256 of each
   slab), and ckpt-10M-sharded loaded at world size 2, each slab's sha256
   that of the world-size-1 load; the launches of K1, K2, dW_h, P1, P2, P4
   and K5 on the mesh path (rank 0's). With two cards or more, the fit
   again over NCCL, one rank a card;
18c. serving on the row-sharded table, in 18b's launch of four ranks on
   the (2, 2) mesh (``serve_mesh_phase``): serve-10M-mesh (phase 4's model
   and 4096 histories, each rank a 5,000,000-row slab, users/s the median
   of 3 batches after a warm-up), serve-1M-merge-mesh (phase 5's, merge
   budget 0: K3 on each 500,000-row slab) and phase 5b's catalog of copies
   (the single pass and the merge: every user rechecked on every slab,
   through both FP32 routes); each against world size 1's lists of phases
   4-5c (scores within TOL_REL relative, ids except at ties; serve-10M-mesh
   also with phase 2's budget fixed at its constant), the four
   ranks' ids, scores and ``predict`` scores bit-equal (sha256), with rank
   0's collectives a batch, the users rechecked (rank 0's and the sum),
   rank 0's serving budgets and route (each rank budgets its share of the
   card the four share) and the path's launches of K1, K4, K3 and both FP32
   routes (rank 0's).

It then prints the kernels' JSON line (each kernel's launches on the main
paths, in all and by path, largest error, card and plain times, its bound on this card, by the
route it takes: FP32 FMAs, or 3xTF32 with the FP32 bound beside as
``bound_fp32_ms``, and the time of one PyTorch call that computes the same
function, where there is one) and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
those lines. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

N_ITEMS = 10_000_000
N_ITEMS_MERGE = 1_000_000
USERS = 4096
USERS_MERGE = 512
SEQ_LEN = 32
DIM = 127
SERVE_CHUNK = 131072
K = 10
REF_USERS = 256
# Phase 5b: a catalog of REPEATS copies of N_ITEMS_MERGE / REPEATS items.
# Every user is rechecked while a catalog (or phase 18c's slab of half of
# it) holds more copies of each item than the k + S <= 41 groups phase 1
# keeps.
REPEATS = 100
# Phase 5d, serve-50M-merge: a catalog past the single-pass merge budget.
N_ITEMS_50M = 50_000_000

TOL_LSTM = 1e-5   # f32; the 127-term sums run in another order, |h| < 1
TOL_SCORE = 2e-5  # f32 dot of 128 terms in another order, scores of order 1
# The 3xTF32 K4 against FP32: within the certificate's eps (a bound), and
# within TOL_SCORE per 128 terms (cc / 128 times it for wider rows: both
# formulations' rounding grows with the terms).
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
# The sparse update's run sums are differences of a running sum (the JAX
# package's design), so a row's summed gradient carries the rounding of the
# rows sorted before it, about 1e-7 of the prefix. Adagrad's first step
# lr * g / sqrt(g^2 + eps) multiplies that by up to 5e3 at |g| = 1e-5, so
# phase 7b checks updated values from this |g| up (gradients everywhere).
G_FLOOR_SPARSE = 1e-4
# The same run sums made on two devices (phases 12-14, card against CPU): the
# two cumsums round differently, and a row's sum, the difference of two
# prefixes of its column, differs by a few ulp of the prefixes' magnitude,
# at most the column's sum_rows |g|. Measured: 1 ulp (attention's criterion
# step, card against CPU; and on the CPU alone against an f64 cumsum).
RUN_SUM_ULPS = 4

# (T, B, D, variants) of K2's checks: the ml1m fit, the bench.py fit, an odd
# D whose w_h (Normal) is beyond a block's shared memory (a cluster of two
# CTAs holds it), the fit-10M-sparse fit (T=64, D=127 Coupled: G*D = 381, not
# a multiple of 4), and D = 512, past what a cluster holds (the L2 route).
K2_SHAPES = [
    (128, 256, 128, (True, False)), (32, 256, 32, (False, True)), (32, 4096, 127, (False,)),
    (64, 256, 127, (True,)), (16, 24, 512, (True, False)),
]
K2_TIMED = (128, 256, 128, True, True)  # the ml1m fit's call: Coupled, packed
BENCH_REPEATS = 5  # continued bench.py-config fits timed, for their spread
# Evaluation: the test sets of benches/large_scale.py at 10M items, the
# users checked against the per-user loop, and the fused-vs-chunked model.
EVAL_USERS = (512, 4096)
EVAL_SEEDS = {512: 1, 4096: 2}  # synthetic_interactions' rng for each test set
EVAL_REF_USERS = 64
N_ITEMS_FUSED = 200_000
USERS_FUSED = 300
K5_ROWS = 1_000_000
# The sparse step's row traffic (P1-P4): the probe's 33,024 rows (one
# items10m step touches 256 x 65 + 256 x 64 occurrences), the 20M-item bf16
# table of items20m_bf16, and WARP's positions at B=256 x T=64, K=5.
ROWS_M = 33_024
N_ITEMS_BF16 = 20_000_000
CAND_P, CAND_K = 256 * 64, 5
# fit-bench's catalog, and the positions P3 and P4 are checked and timed at.
BENCH_ITEMS = 1682
P3_POSITIONS = 8192
# P1/P2/P4 are timed over this many id sets in turn (8 x 34 MB of rows and
# outputs, past the 50 MB L2), so each call finds its rows in device memory
# as a training step does.
COLD_SETS = 8
FIT_USERS, FIT_ITEMS_PER_USER, FIT_T = 20_000, 50, 64
# Phases 12-14: the EWMA, GRU and attention families. The criterion fit's
# sample, its timed fits (GRU's cut to CRITERION_REPEATS_GRU: each of its
# fits runs an eager loop over T=128 forward and backward, ~5,600 launches
# a step, 9-14 s a fit), and the tuned WARP fits' epochs (the tests' 40, 40
# and 20 cut to 4, GRU's to 2).
FAMILIES = ("ewma", "gru", "attention")
CRITERION_SAMPLE = 10_000
CRITERION_REPEATS = 10
CRITERION_REPEATS_GRU = 2
WARP_EPOCHS = {"ewma": 4, "gru": 2, "attention": 4}
# Steps a family's fit profile traces (a window: tracing costs the host
# about 0.5 ms a launch, and GRU's step launches ~5,600 kernels).
PROFILE_STEPS = {"ewma": 10, "gru": 3, "attention": 10}
# WARP selections under two towers may flip only where a candidate's margin
# 1 - pos + cand lies this close to 0.
TOL_MARGIN = 1e-4
# Phases 15a-17: checkpoints. The bf16 table of phase 15c (5M x 128 bf16,
# 1.28 GB: past flax's 2**30-byte chunk, so written in 2 chunks), the
# smallest of the 10M table's 5 chunks phase 15b may cut to when the disk is
# short, and the CUDA symbols of K4 and K1 phase 16's trace must name.
N_ITEMS_CKPT_BF16 = 5_000_000
CKPT_MIN_CHUNKS = 2
TRACE_SYMBOLS = ("score_submax_kernel", "lstm_fwd_smem_kernel")
# Phase 18: the mesh. 18b's (data, model) shape, the time limit of its rank
# groups (and of each collective), and the tolerances (those of
# tests/test_torch_fit.py) its tables' distance from the plain world-size-1
# fit's is printed against.
MESH_SHAPE = (2, 2)
MESH_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 240, 180
MESH_RTOL, MESH_ATOL = 2e-4, 1e-3
# Published peaks of one H100 SXM (dense): FP32 outside the tensor cores,
# TF32 on them, and HBM3. A kernel's bound is the larger of its FLOPs and its
# bytes (each input read once, each output written once) over these; a
# 3xTF32 kernel (K5, dW_h) does 3 TF32 products per FLOP of the function (2
# for bf16 rows) and is bound by those on the TF32 peak, with its FP32 bound
# printed beside.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


# -- the cells. Each imports sbr_rs_tpu_torch from the first checkout on
# sys.path.


def serving_hyper(num_items, seed=42, dtype="float32"):
    """serve-10M's hyperparameters (phase 4) over ``num_items`` items:
    LSTM-127 Normal, T=32, a ``dtype`` table (f32; bf16 for serve-20M-bf16),
    weights from ``seed``."""
    from sbr_rs_tpu_torch.models import lstm

    return (
        lstm.Hyperparameters(num_items, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .table_dtype(dtype)
        .from_seed(seed)
    )


def serving_model(num_items, dev, seed=42, dtype="float32"):
    """serve-10M's model (phase 4) over ``num_items`` items (:func:`serving_hyper`)."""
    return serving_hyper(num_items, seed, dtype).build(dev)


# The JAX package's serving budgets, sized for a 16 GB chip (the port's
# floors, models/base.py's MERGE_BUFFER_FLOOR, SUBMAX_BUFFER_FLOOR and
# PHASE2_BUFFER_FLOOR; main() checks that they agree), as class constants to
# fix on a model: the other side of the card's own budgets.
CONSTANT_BUDGETS = {"_MERGE_BUFFER_BYTES": 6 << 30, "_SUBMAX_BUFFER_BYTES": 6 << 30,
                    "_PHASE2_BUFFER_BYTES": 1_200_000_000}


def stack_bytes(route, n, u):
    """The maxima stacks a streamed top-k's ``route`` allocates for ``u``
    users over ``n`` rows, as the kernel sizes them: the group maxima on the
    single pass, and the subgroup maxima beside them when it refines."""
    from sbr_rs_tpu_torch.ops.topk_kernels import groupmax_rows

    if not route.single_pass:
        return 0
    subs = groupmax_rows(n, route.sub) if route.sub < route.group else 0
    return (groupmax_rows(n, route.group) + subs) * u * 4


def describe_route(route, n, kk):
    """A streamed top-k's route in words."""
    if route.single_pass:
        how = f"single pass, group {route.group}, " + (
            f"subgroups of {route.sub}" if route.sub < route.group else "group maxima only")
    else:
        how = f"running merge over {-(-n // SERVE_CHUNK)} chunks, group {route.group}"
    return f"{how}, phase 2 {route.slots} of {kk} slots a step"


def card_memory(label, dev):
    """Print what the serving budgets read of the card ``dev``: its free and
    total bytes, this process's releasable cache beside the allocator's
    reserved and allocated bytes, and a batch's share of it all."""
    import torch
    from sbr_rs_tpu_torch.models import base

    reading = base.card_reading(dev)
    _, free, cached, total = reading
    print(f"{label}: the card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free (mem_get_info); this process's "
          f"allocator holds {cached / 1e9:.2f} GB it could release (reserved {torch.cuda.memory_reserved(dev) / 1e9:.2f}"
          f", allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f}); a batch's share "
          f"{base.budget_share([reading]) / 1e9:.2f} GB", flush=True)


def serve_side(label, model, histories, side, constants, after=None):
    """One side of the serving budgets: ``recommend_batch(k=K)`` of
    ``histories`` with ``constants`` set on the model (none: the budgets the
    card derives at each call), a warm-up batch, then 3 timed. Prints and
    returns the budgets and route of the last batch's streamed top-k
    (``topk_streamed.last_route``), users/s (the median), the users the
    certificate rechecked a batch, the last batch's peak allocation beside
    its maxima stacks, and its lists; ``after(result)`` runs while the
    constants are still set."""
    import torch

    from sbr_rs_tpu_torch.models.base import BUDGET_MARGIN, topk_streamed

    for name, value in constants.items():
        setattr(model, name, value)
    try:
        model.recommend_batch(histories, k=K)
        before = topk_streamed.rechecked_users
        times = []
        for _ in range(3):
            topk_streamed.last_route = None
            torch.cuda.reset_peak_memory_stats(model.device)
            held = torch.cuda.memory_allocated(model.device)
            t0 = time.perf_counter()
            ids, vals = model.recommend_batch(histories, k=K, return_scores=True)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(model.device) - held
        route, budgets = topk_streamed.last_route
        n, u = model.hyper._num_items, len(histories)
        stacks = stack_bytes(route, n, u)
        margin = BUDGET_MARGIN * torch.cuda.get_device_properties(model.device).total_memory
        kk = min(K + max(len(h) for h in histories), n)
        ups = u / statistics.median(times)
        print(f"{label}, {SIDE_NAMES[side]}: merge {budgets[0] / 1e9:.2f} GB, submax {budgets[1] / 1e9:.2f} GB, "
              f"phase 2 {budgets[2] / 1e9:.2f} GB; {describe_route(route, n, kk)}; {ups:.1f} users/s (median of 3: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per batch of {u}); the certificate sent "
              f"{(topk_streamed.rechecked_users - before) / 3:g} of {u} users a batch to the FP32 route; the last "
              f"batch's peak allocation {peak / 1e9:.3f} GB: its maxima stacks {stacks / 1e9:.3f} GB and "
              f"{(peak - stacks) / 1e9:.3f} GB more, against the margin's {margin / 1e9:.2f} GB", flush=True)
        if not constants and peak > budgets[0]:
            raise SmokeFailure(f"{label}: the batch took {peak} bytes, more than the share {budgets[0]} it was given")
        got = {"budgets_bytes": list(budgets), "route": route._asdict(), "users_per_s": ups,
               "batch_ms": [t * 1e3 for t in times], "peak_bytes": peak, "stack_bytes": stacks,
               "ids": np.asarray(ids), "vals": vals}
        if after is not None:
            after(got)
    finally:
        for name in constants:
            delattr(model, name)
    return got


# The sides of the serving budgets: the card's, the JAX package's constants,
# and (serve-10M, whose route is the same on both sides) the card's with phase
# 2's budget fixed at its constant, to part phase 2's step from the reading.
SIDE_NAMES = {"card": "the card's budgets", "constants": "the JAX package's constants",
              "phase2": "the card's budgets, phase 2's at its constant"}


def serving_histories(num_items, users=USERS, seed=7):
    """``users`` histories of 2-31 items from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, num_items, rng.integers(2, 32)).tolist() for _ in range(users)]


def eval_test(users, num_items=N_ITEMS):
    """The held-out users of eval-10M-512 and eval-10M-4096 (phase 6b), over
    ``num_items`` items."""
    from sbr_rs_tpu_torch import datasets

    return datasets.synthetic_interactions(users, num_items, 20, rng=EVAL_SEEDS[users]).to_compressed()


def fit_ml1m_model(dev, dtype="float32"):
    """fit-ml1m's model (phase 8): Coupled LSTM-128, T=128, Hinge, Adam."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

    return (
        lstm.Hyperparameters(3706, 128)
        .embedding_dim(128)
        .table_dtype(dtype)
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


def fit_ml1m_data():
    """fit-ml1m's data: ML-1M's shape, 6040 users x 3706 items x 165."""
    from sbr_rs_tpu_torch import datasets

    return datasets.synthetic_interactions(6040, 3706, 165, rng=0).to_compressed()


def fit_bench_model(dev, mesh=None):
    """fit-bench's model (phase 9): Normal LSTM-32, T=32, WARP, Adagrad
    (over ``mesh`` when given: phase 18a)."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

    return (
        lstm.Hyperparameters(BENCH_ITEMS, 32)
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
        .mesh(mesh)
        .build(dev)
    )


def items_hyper(num_items, dtype):
    """``benches/large_scale.py bench_items`` at dim 127, as ``items10m``
    and ``items20m_bf16`` build it (the LSTM variant left at its default):
    the hyperparameters of fit-10M-sparse (phase 10), fit-20M-bf16 (11) and
    fit-10M-sparse-mesh (18b)."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

    return (
        lstm.Hyperparameters(num_items, FIT_T)
        .embedding_dim(DIM)
        .learning_rate(0.1)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(1)
        .batch_size(256)
        .packed(True)
        .sparse_updates(True)
        .table_dtype(dtype)
        .from_seed(0)
    )


def fit_bench_split():
    """fit-bench's data: ML-100K's shape (943 x 1682 x 106), split 0.2 by
    user; (train, test) interactions."""
    from sbr_rs_tpu_torch import data as sbr_data
    from sbr_rs_tpu_torch import datasets

    raw = datasets.synthetic_interactions(943, BENCH_ITEMS, 106, rng=0)
    return sbr_data.user_based_split(raw, np.random.default_rng(42), 0.2)


def criterion_sample():
    """The criterion ``fit`` cell's data (``benches/benchmark.py:40-49``): a
    10,000-interaction sample, drawn by ``default_rng(0).choice``, of
    ML-100K-shaped synthetic data (943 x 1682 x 106)."""
    from sbr_rs_tpu_torch import data as sbr_data
    from sbr_rs_tpu_torch import datasets

    raw = datasets.synthetic_interactions(943, BENCH_ITEMS, 106, rng=0)
    idx = np.random.default_rng(0).choice(len(raw), size=CRITERION_SAMPLE, replace=False)
    return sbr_data.Interactions(
        raw.num_users, raw.num_items, raw.user_ids[idx], raw.item_ids[idx], raw.timestamps[idx]
    ).to_compressed()


def family_hyper(family, num_items, seq_len):
    """``family``'s (``"ewma"``, ``"gru"``, ``"attention"``) hyperparameters."""
    from sbr_rs_tpu_torch import models

    return getattr(models, family).Hyperparameters(num_items, seq_len)


def criterion_model(family, dev):
    """The criterion ``fit`` cell's model (``benches/benchmark.py:52-64``):
    dim 32, T=128, Hinge, Adagrad, lr 0.16, l2 4e-4, 3 epochs, seed 0 (the
    batch of 32 and the unpacked rows are the defaults)."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer

    return (
        family_hyper(family, BENCH_ITEMS, 128)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(4e-4)
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(3)
        .from_seed(0)
        .build(dev)
    )


def tuned_warp_model(family, dev, dropout=0.0):
    """The family's tuned WARP configuration of
    ``tests/test_integration_ml100k.py`` (ewma_warp :107-111, GRU :264-274,
    attention :309-321; seed 42), with its epochs cut to WARP_EPOCHS."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer

    seq_len, batch, lr, l2 = {
        "ewma": (128, 16, 0.06, 0.016), "gru": (128, 16, 0.01, 0.03), "attention": (32, 64, 3e-3, 3e-4),
    }[family]
    hp = (
        family_hyper(family, BENCH_ITEMS, seq_len)
        .embedding_dim(32)
        .learning_rate(lr)
        .l2_penalty(l2)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAM)
        .num_epochs(WARP_EPOCHS[family])
        .batch_size(batch)
        .lr_schedule("cosine")
        .from_seed(42)
    )
    if family == "ewma":
        hp = hp.alpha_init(2.0)
    if family == "attention":
        hp = hp.num_layers(1).num_heads(1).dropout(dropout)
    return hp.build(dev)


def family_serving_model(family, num_items, dev, seed=42):
    """serve-10M's shape for ``family``: dim 127, T=32, an f32 table of
    ``num_items`` items, weights from ``seed`` (attention: 2 layers, one head,
    the only count that divides 127)."""
    return family_hyper(family, num_items, SEQ_LEN).embedding_dim(DIM).from_seed(seed).build(dev)


def cand_inputs(n_rows, c, dtype, offset, dev, gen):
    """WARP's candidate-score inputs for P3/P4: a table ``[n_rows, c]`` (a
    view ``offset`` rows into its storage), ``haug [P3_POSITIONS, c]`` and
    CAND_K candidates a position, a few outside the table (clamped)."""
    import torch

    table = torch.randn((n_rows + offset, c), device=dev, generator=gen, dtype=dtype)[offset:]
    haug = torch.randn((P3_POSITIONS, c), device=dev, generator=gen) * c**-0.5
    cand = torch.randint(-2, n_rows + 2, (P3_POSITIONS, CAND_K), device=dev, generator=gen)
    return table, haug, cand


def device_ms(fn, reps=20):
    """Device time per call of ``fn``: the self time of its kernels under
    ``torch.profiler`` over ``reps`` calls after a warm-up. For a call of
    tens of microseconds the host's launch cost from Python is as large
    as the kernel, and CUDA events around one call would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # the profiler now and then returns an empty trace
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        )
        if busy_us > 0:
            if attempt:
                print(f"  device_ms: {attempt} empty profiler trace(s) before this one", flush=True)
            return busy_us / 1e3 / reps
    raise SmokeFailure("torch.profiler saw no device time")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sbr_rs_tpu_torch import data as sbr_data
    from sbr_rs_tpu_torch import datasets, evaluation
    from sbr_rs_tpu_torch.models import Loss, Optimizer, base, engine, lstm
    from sbr_rs_tpu_torch.models.base import topk_streamed
    from sbr_rs_tpu_torch.models.towers import lstm_apply
    from sbr_rs_tpu_torch.ops import _build
    from sbr_rs_tpu_torch.ops import lstm_kernels as lk
    from sbr_rs_tpu_torch.ops import row_kernels as rowk
    from sbr_rs_tpu_torch.ops import topk_kernels as tk
    from sbr_rs_tpu_torch.ops.sampling import warp_select
    from sbr_rs_tpu_torch.utils.convert import params_to_numpy
    from sbr_rs_tpu_torch.utils.tree import flatten, map_leaves

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def mark(label):
        """The time since the start, at the start of a phase."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {label}", flush=True)
    # Full f32 for every plain matmul here (the references must not round
    # through TF32), except where phase 4 serves with the caller's flag on.
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
    mark("phase 2")
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

    from torch.profiler import ProfilerActivity, profile

    def kernels_per_call(fn, reps=5):
        """Device kernels (and memsets/copies) that one call of ``fn`` runs,
        counted by ``torch.profiler`` over ``reps`` calls after a warm-up."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        ]
        return sum(e.count for e in events) / reps, sorted({e.key[:60] for e in events})

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
    # kernel name -> {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    report = {}

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def record(name, err, ms=None, plain_ms=None, work=None, library_ms=None, tf32_products=None):
        """Keep the largest error; with ``ms``, the timed call's numbers and
        its bound from ``work = (flops, bytes)`` at the same shape: FLOPs on
        the FP32 peak, or, for a 3xTF32 kernel, ``tf32_products`` x FLOPs on
        the TF32 peak (the FP32 bound then kept beside as ``bound_fp32_ms``)."""
        r = report.setdefault(name, {
            "max_abs_err": 0.0, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
        })
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            flops, moved = work
            t_fp32, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, moved / PEAK_HBM_BYTES * 1e3
            t_ops = t_fp32 if tf32_products is None else tf32_products * flops / PEAK_TF32_FLOPS * 1e3
            r.update(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            )
            route = "FP32" if tf32_products is None else f"{tf32_products}xTF32"
            fp32 = ""
            if tf32_products is not None:
                r["bound_fp32_ms"] = max(t_fp32, t_bytes)
                fp32 = f"; FP32 bound {r['bound_fp32_ms']:.3f} ms ({r['bound_fp32_ms'] / ms:.1%})"
            print(
                f"  bound: {r['bound_ms']:.3f} ms ({r['bound_by']}, {route}: {flops:.3e} FLOP, {moved:.3e} B); "
                f"kernel at {r['bound_ms'] / ms:.1%} of it{fp32}", flush=True,
            )

    def tol_score(cc):
        return TOL_SCORE * max(1.0, cc / 128)

    def within_eps(name, got, want, eps):
        """|got - want| <= eps[u] wherever both are finite (the -inf
        positions are compared by ``compare``); returns the largest ratio."""
        both = torch.isfinite(got) & torch.isfinite(want)
        ratio = float(torch.where(both, (got - want).abs() / eps, torch.zeros_like(got)).max())
        if not ratio <= 1.0:
            raise SmokeFailure(f"{name}: an error {ratio:.3f} x the certificate's eps")
        return ratio

    def k4_rows_on_m(rows, reps, n, sub, group):
        """K4 on ``rows`` (``lo`` 0) through its C entry point on the
        rows-on-M tile (the wrapper takes the tile ``submax_tile`` chooses):
        for timing it at a shape that takes rows on N."""
        c, cc = rows.shape
        u = reps.shape[0]
        scratch = tk._split_reps_scratch(u, cc, dev, 0)
        smax = torch.empty((tk.groupmax_rows(c, sub), u), device=dev)
        gmax = torch.empty((tk.groupmax_rows(c, group), u), device=dev)
        fn = getattr(_build.library(), "sbr_score_submax_tc_bf16" if rows.dtype == torch.bfloat16
                     else "sbr_score_submax_tc_f32")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _build.check(fn(rows.data_ptr(), reps.data_ptr(), scratch.data_ptr(), smax.data_ptr(), gmax.data_ptr(),
                        c, cc, u, 0, n, sub, group, 0, 0, torch.cuda.current_stream(dev).cuda_stream),
                     "score_submax_groupmax on rows on M")
        return smax, gmax

    def k4_tile_phase():
        """Phase 3b: K3's and K4's two 3xTF32 tiles (rows on the wgmma's N for
        narrow rows, rows on its M past that tile's shared memory), each call
        on the tile ``submax_tile`` chooses (checked by its counter), against
        the plain version within the certificate's eps and tol_score(cc), with
        K3's group maxima (reps split in the call and by split_reps) equal to
        K4's bit for bit: f32 and bf16 rows at cc = 2, 8, 17, 33, 40, 41 and
        each dtype's last rows-on-N width and the next; (sub, group) = (8,
        16), (16, 128), (32, 128); U = 1, 127, 129 and 4096; slabs that start
        off a 16-byte boundary, ragged ends, lo > 0 with the catalog ending
        inside the call, and calls of several row blocks a persistent block.
        Then the error on all-positive inputs against the stated bound, and
        K4 timed at the LSTM-32 catalog's shape (50M x 33, U = 4096 and 1) on
        both tiles, and at 10M x 128 x 4096 (rows on M)."""
        mark("phase 3b")
        lib = _build.library()
        lib.sbr_smem_per_block_optin.restype = ctypes.c_int
        optin = lib.sbr_smem_per_block_optin()
        last = {dt: max(cc for cc in range(1, 513) if tk.submax_tile(cc, dt, optin))
                for dt in (torch.float32, torch.bfloat16)}
        print(f"phase 3b K3/K4 tiles: opt-in shared memory {optin} B a block; rows on N up to cc = "
              f"{last[torch.float32]} (f32), {last[torch.bfloat16]} (bf16)", flush=True)
        seen = dict.fromkeys(tk.TILES, 0)

        def check(label, rows, reps, lo, n, sub, group):
            cc = rows.shape[1]
            tile = tk.TILES[tk.submax_tile(cc, rows.dtype, optin)]
            before = dict(tk.score_submax_groupmax.tile_launches), dict(tk.score_groupmax.tile_launches)
            smax, gmax = tk.score_submax_groupmax(rows, reps, lo, n, sub, group)
            k3 = tk.score_groupmax(rows, reps, lo, n, group)
            k3_split = tk.score_groupmax(rows, reps, lo, n, group, split=tk.split_reps(reps, rows.dtype))
            for counter, was, calls in ((tk.score_submax_groupmax.tile_launches, before[0], 1),
                                        (tk.score_groupmax.tile_launches, before[1], 2)):
                moved = {k: counter[k] - was[k] for k in tk.TILES if counter[k] != was[k]}
                if moved != {tile: calls}:
                    raise SmokeFailure(f"K3/K4 {label}: launches by tile {moved}, expected {calls} on {tile}")
            seen[tile] += 1
            if not (torch.equal(k3, gmax) and torch.equal(k3_split, gmax)):
                raise SmokeFailure(f"K3 {label}: not K4's group maxima bit for bit")
            ps, pg = tk.score_submax_groupmax_plain(rows, reps, lo, n, sub, group)
            eps = tk.phase1_error_bound(rows, reps)
            err, ratio = 0.0, 0.0
            for part, got, want in (("submax", smax, ps), ("groupmax", gmax, pg)):
                want = tk._pad_to(want, got.shape[0])
                err = max(err, compare(f"K4 {label} {part}", got, want, tol_score(cc), quiet=True))
                ratio = max(ratio, within_eps(f"K4 {label} {part}", got, want, eps))
            print(f"  {tile} {label}: max_abs_err {err:.3e} (tol {tol_score(cc):.0e}), at most {ratio:.4f} x eps; "
                  f"K3 = K4's group maxima", flush=True)
            record("score_submax_groupmax", err)
            record("score_groupmax", err)

        pairs = ((8, 16), (16, 128), (32, 128))
        users = (1, 127, 129)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            widths = sorted({2, 8, 17, 33, 40, 41, last[dtype], last[dtype] + 1})
            for i, cc in enumerate(widths):
                # Every second width over several row blocks a persistent block.
                c = 100_003 if i % 2 == 0 else 3_001
                u = users[i % 3]
                base = torch.randn((c + 8, cc), device=dev, generator=gen).to(dtype)
                rows = base[3 : 3 + c]  # 3 rows in: off a 16-byte boundary unless 16 | 3 cc x itemsize
                reps = (torch.randn((u, cc), device=dev, generator=gen) * cc**-0.5).contiguous()
                for j, (sub, group) in enumerate(pairs):
                    lo, n = (0, c) if j == 0 else (4096, 4096 + c - 1000 * j)
                    check(f"{name} cc={cc} c={c} U={u} {sub}/{group} lo={lo} n={n}", rows, reps, lo, n, sub, group)
            cc = 33
            base = torch.randn((100_003, cc), device=dev, generator=gen).to(dtype)
            reps = (torch.randn((USERS, cc), device=dev, generator=gen) * cc**-0.5).contiguous()
            for sub, group in pairs:
                check(f"{name} cc={cc} c=100003 U={USERS} {sub}/{group}", base, reps, 0, 100_003, sub, group)
            del base, rows, reps
        if not all(seen.values()):
            raise SmokeFailure(f"phase 3b: a tile never ran ({seen})")
        # At U = 4096 and cc = 48 both layouts of the split reps hold as many
        # floats, and f32 rows take rows on M where bf16 rows take rows on N:
        # K3 refuses the split made for the other dtype.
        reps = torch.randn((USERS, 48), device=dev, generator=gen).contiguous()
        for rows_dtype, split_dtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            rows = torch.randn((4096, 48), device=dev, generator=gen).to(rows_dtype)
            try:
                tk.score_groupmax(rows, reps, 0, 4096, 128, split=tk.split_reps(reps, split_dtype))
            except ValueError as e:
                print(f"  K3 {rows_dtype} rows, a split for {split_dtype} rows: refused ({e})", flush=True)
            else:
                raise SmokeFailure(f"K3: a split for {split_dtype} rows taken for {rows_dtype} rows")

        # The bound on the rows-on-N tile: all-positive inputs, one nonzero
        # row in 16 (as phase 3's check), K4 at sub 16 and K3 at group 16.
        for cc in (33, 40):
            for dtype in (torch.float32, torch.bfloat16):
                c = 32768
                rows = torch.zeros((c, cc), device=dev)
                rows[::16] = torch.rand((c // 16, cc), device=dev, generator=gen) * 0.5 + 0.5
                rows = rows.to(dtype)
                rp = (torch.rand((4096, cc), device=dev, generator=gen) * 0.5 + 0.5).contiguous()
                smax, _ = tk.score_submax_groupmax(rows, rp, 0, c, 16, 32)
                gmax = tk.score_groupmax(rows, rp, 0, c, 16)
                exact = rows[::16].double() @ rp.double().T
                scale = rp.double() @ rows.float().abs().amax(dim=0).double()
                gamma1 = tk.phase1_gamma(cc, dtype, tensor_cores=True) - tk._gamma_fp32(cc)
                for kernel, got in (("K4", smax), ("K3", gmax)):
                    ratio = float(((got[: c // 16].double() - exact).abs() / scale).max())
                    print(f"  {kernel} rows on N cc={cc} {dtype}: largest |s - s_fp64| / (sum |reps| M) "
                          f"{ratio:.3e}; phase-1 gamma {gamma1:.3e} ({ratio / gamma1:.1%} of it)", flush=True)
                    if not ratio <= gamma1:
                        raise SmokeFailure(f"{kernel} rows on N cc={cc}: error {ratio:.3e} above {gamma1:.3e}")
        del rows, rp, smax, gmax, exact, scale
        torch.cuda.empty_cache()

        # The LSTM-32 catalog's shape: 50M x 33 f32, U = 4096 (a batch) and
        # U = 1 (a request), on both tiles; three 131,072-row chunks checked.
        n50, cc = N_ITEMS_50M, 33
        table = torch.randn((n50, cc), device=dev, generator=gen) * 0.1
        for u in (USERS, 1):
            reps = (torch.randn((u, cc), device=dev, generator=gen) * cc**-0.5).contiguous()
            reps[:, -1] = 1.0
            before = tk.score_submax_groupmax.tile_launches["rows_on_n"]
            smax, gmax = tk.score_submax_groupmax(table, reps, 0, n50, 32, 128)
            if tk.score_submax_groupmax.tile_launches["rows_on_n"] != before + 1:
                raise SmokeFailure("K4 at 50M x 33: not on the rows-on-N tile")
            eps = tk.phase1_error_bound(table, reps)
            err, ratio = 0.0, 0.0
            for lo in (0, 25 * SERVE_CHUNK, n50 - n50 % SERVE_CHUNK):
                ps, pg = tk.score_submax_groupmax_plain(table[lo : lo + SERVE_CHUNK], reps, lo, n50, 32, 128)
                for part, got, want in (("submax", smax[lo // 32 : lo // 32 + ps.shape[0]], ps),
                                        ("groupmax", gmax[lo // 128 : lo // 128 + pg.shape[0]], pg)):
                    err = max(err, compare(f"K4 50M {part} rows {lo}+", got, want, TOL_SCORE, quiet=True))
                    ratio = max(ratio, within_eps(f"K4 50M {part} rows {lo}+", got, want, eps))
            if not torch.isneginf(gmax[-(gmax.shape[0] - (n50 + 127) // 128):]).all():
                raise SmokeFailure("K4 at 50M x 33: pad rows are not -inf")
            del smax, gmax
            work = (2.0 * n50 * u * cc, n50 * cc * 4 + u * cc * 4 + 4.0 * u * (n50 // 32 + n50 // 128))
            ms_n = time_ms(lambda: tk.score_submax_groupmax(table, reps, 0, n50, 32, 128), reps=5)
            ms_m = time_ms(lambda: k4_rows_on_m(table, reps, n50, 32, 128), reps=5)
            ms_n2 = time_ms(lambda: tk.score_submax_groupmax(table, reps, 0, n50, 32, 128), reps=5)
            bound = max(3 * work[0] / PEAK_TF32_FLOPS, work[1] / PEAK_HBM_BYTES) * 1e3
            yard = max(work[0] / PEAK_TF32_FLOPS, work[1] / PEAK_HBM_BYTES) * 1e3
            print(f"  K4 {n50} x {cc} f32, U={u}, 32/128: max_abs_err {err:.3e}, at most {ratio:.4f} x eps; rows on N "
                  f"{ms_n:.3f} / {ms_n2:.3f} ms, rows on M {ms_m:.3f} ms; 3xTF32 bound {bound:.3f} ms "
                  f"({bound / ms_n:.1%}), the benchmark's k4_roofline bound {yard:.3f} ms ({yard / ms_n:.1%})",
                  flush=True)
            del reps, eps
        del table
        torch.cuda.empty_cache()
        # The 10M serving shape (rows on M at cc = 128), as phase 4 times it.
        table = torch.randn((N_ITEMS, DIM + 1), device=dev, generator=gen) * 0.1
        reps = (torch.randn((USERS, DIM + 1), device=dev, generator=gen) * (DIM + 1) ** -0.5).contiguous()
        before = tk.score_submax_groupmax.tile_launches["rows_on_m"]
        ms = time_ms(lambda: tk.score_submax_groupmax(table, reps, 0, N_ITEMS, 32, 128), reps=3)
        if tk.score_submax_groupmax.tile_launches["rows_on_m"] != before + 4:
            raise SmokeFailure("K4 at 10M x 128: not on the rows-on-M tile")
        print(f"  K4 {N_ITEMS} x {DIM + 1} f32, U={USERS}, 32/128, rows on M: {ms:.1f} ms", flush=True)
        del table, reps
        torch.cuda.empty_cache()

    # -- phase 3: kernels against their plain versions ----------------------------
    mark("phase 3")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def geometry(b, d, coupled, backward=False):
        cluster, rows, threads, smem, route = lk.recurrence_geometry(b, d, 3 if coupled else 4, sms,
                                                                     backward=backward)
        return f"route {route}, cluster {cluster}, {rows} rows, {threads} threads, {smem} B"

    def check_k1(label, xz, w_h, keep, coupled):
        """K1 against its plain version, and two calls bit-equal."""
        h, c = lk.lstm_fwd(xz, w_h, keep, coupled)
        h2, c2 = lk.lstm_fwd(xz, w_h, keep, coupled)
        if not (torch.equal(h, h2) and torch.equal(c, c2)):
            raise SmokeFailure(f"K1 ({label}): two calls differ")
        hp, cp = lk.lstm_fwd_plain(xz, w_h, keep, coupled)
        print(f"  K1 {label}: {geometry(xz.shape[1], w_h.shape[0], coupled)}; two calls bit-equal", flush=True)
        return max(compare(f"hidden ({label})", h, hp, TOL_LSTM), compare(f"cell ({label})", c, cp, TOL_LSTM))

    def k1_inputs(t_len, b, d, coupled):
        gates = 3 if coupled else 4
        xz = torch.randn((t_len, b, gates * d), device=dev, generator=gen)
        w_h = torch.randn((d, gates * d), device=dev, generator=gen) * d**-0.5
        starts = torch.rand((t_len, b, 1), device=dev, generator=gen) < 0.1
        return xz, w_h, starts

    def k1_work(xz, w_h, keep):
        t_len, b, gd = xz.shape
        return 2.0 * t_len * b * w_h.shape[0] * gd, nbytes(xz, w_h, keep) + 2 * 4 * t_len * b * w_h.shape[0]

    def fp32_bound_ms(work):
        flops, moved = work
        return max(flops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES) * 1e3

    print(f"phase 3 K1 lstm_fwd: U={USERS} T={SEQ_LEN} D={DIM} (the serving shape)", flush=True)
    for coupled in (False, True):
        xz, w_h, starts = k1_inputs(SEQ_LEN, USERS, DIM, coupled)
        for keep in (torch.ones_like(starts, dtype=torch.float32), (~starts).float()):
            label = f"{'coupled' if coupled else 'normal'}, {'starts' if keep.min() == 0 else 'no starts'}"
            err = check_k1(label, xz, w_h, keep, coupled)
            record("lstm_fwd", err)
            if not coupled and keep.min() == 1:  # the serving path's call
                ms = time_ms(lambda: lk.lstm_fwd(xz, w_h, keep, coupled))
                plain_ms = time_ms(lambda: lk.lstm_fwd_plain(xz, w_h, keep, coupled))
                print(f"  time at the serving shape: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; FP32 bound "
                      f"{fp32_bound_ms(k1_work(xz, w_h, keep)):.3f} ms", flush=True)
    # The library yardstick where one call computes the same function: cuDNN's
    # LSTM (Normal gate order, no resets, its own input projection) against
    # the port's projection + K1, in full FP32 (cuDNN's TF32 flag off for it).
    x = torch.randn((USERS, SEQ_LEN, DIM), device=dev, generator=gen)
    params = {
        "w_x": torch.randn((DIM, 4 * DIM), device=dev, generator=gen) * DIM**-0.5,
        "w_h": torch.randn((DIM, 4 * DIM), device=dev, generator=gen) * DIM**-0.5,
        "b": torch.randn((4 * DIM,), device=dev, generator=gen) * 0.1,
    }

    def cudnn_lstm(p, d):
        lstm_mod = torch.nn.LSTM(d, d, batch_first=True).to(dev)
        with torch.no_grad():
            lstm_mod.weight_ih_l0.copy_(p["w_x"].T)
            lstm_mod.weight_hh_l0.copy_(p["w_h"].T)
            lstm_mod.bias_ih_l0.copy_(p["b"])
            lstm_mod.bias_hh_l0.zero_()
        return lstm_mod

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = cudnn_lstm(params, DIM)
        with torch.no_grad():
            ours_out = lk.lstm_apply_kernel(params, x, False)
            lib_out = lib(x)[0]
            lib_err = float((ours_out - lib_out).abs().max())
            ours_ms = time_ms(lambda: lk.lstm_apply_kernel(params, x, False))
            lib_fwd_ms = time_ms(lambda: lib(x))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"  library: torch.nn.LSTM (cuDNN, FP32) at the serving shape, Normal, no starts: {lib_fwd_ms:.3f} ms "
          f"against projection + K1 {ours_ms:.3f} ms ({lib_fwd_ms / ours_ms:.2f}x the port's time); outputs "
          f"differ by at most {lib_err:.3e}", flush=True)
    if not lib_err <= 1e-3:
        raise SmokeFailure(f"cuDNN's LSTM is not the same function here: max diff {lib_err:.3e}")
    del x, params, lib, ours_out, lib_out
    # The training shapes: ml1m (the JSON line's time: where K1 costs the most)
    # and fit-10M-sparse; then the wide (L2) route at D = 512.
    for t_len, b, d, timed in ((128, 256, 128, True), (64, 256, 127, False)):
        xz, w_h, starts = k1_inputs(t_len, b, d, True)
        keep = (~starts).float()
        label = f"T={t_len} B={b} D={d} coupled, starts"
        err = check_k1(label, xz, w_h, keep, True)
        ms = time_ms(lambda: lk.lstm_fwd(xz, w_h, keep, True))
        plain_ms = time_ms(lambda: lk.lstm_fwd_plain(xz, w_h, keep, True))
        print(f"  time ({label}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; FP32 bound "
              f"{fp32_bound_ms(k1_work(xz, w_h, keep)):.3f} ms", flush=True)
        if timed:
            record("lstm_fwd", err, ms, plain_ms, work=k1_work(xz, w_h, keep))
        else:
            record("lstm_fwd", err)
    for coupled in (False, True):
        xz, w_h, starts = k1_inputs(16, 24, 512, coupled)
        if lk.recurrence_geometry(24, 512, 3 if coupled else 4, sms)[4] != "l2":
            raise SmokeFailure("K1 at D=512 does not take the L2 route")
        record("lstm_fwd", check_k1(f"T=16 B=24 D=512 {'coupled' if coupled else 'normal'}, starts (wide route)",
                                    xz, w_h, (~starts).float(), coupled))
    del xz, w_h, starts, keep

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
                h2, c2 = lk.lstm_fwd(xz, w_h, keep, coupled)
                if not (torch.equal(h, h2) and torch.equal(c, c2)):
                    raise SmokeFailure(f"K1 ({label}): two calls differ")
                hp, cp = lk.lstm_fwd_plain(xz, w_h, keep, coupled)
                record("lstm_fwd", max(
                    compare(f"K1 hidden ({label})", h, hp, TOL_LSTM, quiet=True),
                    compare(f"K1 cell ({label})", c, cp, TOL_LSTM, quiet=True),
                ))
                dxz, dwh = lk.lstm_bwd(xz, w_h, h, c, g, keep, coupled)
                dxz2, dwh2 = lk.lstm_bwd(xz, w_h, h, c, g, keep, coupled)
                if not (torch.equal(dxz, dxz2) and torch.equal(dwh, dwh2)):
                    raise SmokeFailure(f"K2 ({label}): two calls differ")
                print(f"  K2 {label}: {geometry(b, d, coupled, backward=True)}; two calls bit-equal (K1 too)",
                      flush=True)
                pdxz, pdwh = lk.lstm_bwd_plain(xz, w_h, h, c, g, keep, coupled)
                err = compare(f"K2 dxz ({label})", dxz, pdxz, TOL_DXZ)
                err_w = compare_rel(f"K2 dW_h ({label})", dwh, pdwh, TOL_DWH)
                before = lk.lstm_bwd_dwh.launches
                red, red_again = lk.lstm_bwd_dwh(h, keep, dxz), lk.lstm_bwd_dwh(h, keep, dxz)
                if lk.lstm_bwd_dwh.launches - before != 2:
                    raise SmokeFailure(f"dW_h ({label}): {lk.lstm_bwd_dwh.launches - before} launches for 2 calls")
                if not torch.equal(red, red_again):
                    raise SmokeFailure(f"dW_h ({label}): two calls differ")
                err_w = max(err_w, compare_rel(
                    "  dW_h reduction alone (two calls bit-equal)", red, lk.lstm_bwd_dwh_plain(h, keep, dxz), TOL_DWH,
                ))
                ms = time_ms(lambda: lk.lstm_bwd(xz, w_h, h, c, g, keep, coupled))
                plain_ms = time_ms(lambda: lk.lstm_bwd_plain(xz, w_h, h, c, g, keep, coupled))
                # dW_h by device time: at tens of microseconds a CUDA-event
                # time would include the host's launch cost from Python.
                red_ms = device_ms(lambda: lk.lstm_bwd_dwh(h, keep, dxz))
                red_plain_ms = device_ms(lambda: lk.lstm_bwd_dwh_plain(h, keep, dxz))
                fwd_ms = time_ms(lambda: lk.lstm_fwd(xz, w_h, keep, coupled))
                # The recurrence's own bound: the recomputed gates and dh, two
                # [T*B, D] x [D, G*D]-sized products (dW_h is the next kernel's).
                rec_work = (4.0 * t_len * b * gates * d * d, nbytes(xz, w_h, h, c, g, keep, dxz))
                print(
                    f"  time: K2 {ms:.3f} ms (plain {plain_ms:.3f}; FP32 bound of the recurrence "
                    f"{fp32_bound_ms(rec_work):.3f}), K1 at this shape {fwd_ms:.3f} ms; "
                    f"dW_h reduction {red_ms:.4f} ms device time (plain {red_plain_ms:.4f})",
                    flush=True,
                )
                if (t_len, b, d, coupled, with_starts) != K2_TIMED:
                    record("lstm_bwd", err)
                    record("lstm_bwd_dwh", err_w)
                    continue
                # dz @ w_h^T at every step, and the dW_h product.
                prod = 2.0 * (t_len - 1) * b * d * gates * d
                record("lstm_bwd", err, ms, plain_ms, work=(
                    2.0 * t_len * b * gates * d * d + prod, nbytes(xz, w_h, h, c, g, keep, dxz, dwh),
                ))
                h_prev = (h[:-1] * keep[1:]).reshape(-1, d)
                dz = dxz[1:].reshape(-1, gates * d)
                mm_ms = device_ms(lambda: torch.mm(h_prev.T, dz))
                per_call, names = kernels_per_call(lambda: lk.lstm_bwd_dwh(h, keep, dxz))
                print(
                    f"  library: torch.mm of the dW_h product alone {mm_ms:.4f} ms device time; the kernel "
                    f"{red_ms:.4f} ms is {mm_ms / red_ms:.2f}x as fast; {per_call:g} device launches per dW_h "
                    f"call: {names}", flush=True,
                )
                if per_call != 1:
                    raise SmokeFailure(f"dW_h: {per_call} device launches per call, not 1")
                record("lstm_bwd_dwh", err_w, red_ms, red_plain_ms, work=(prod, nbytes(h, keep, dxz, dwh)),
                       library_ms=mm_ms, tf32_products=3)
    # T = 1: no step has an h[t-1], so dW_h is zero.
    h1 = torch.randn((1, 256, 128), device=dev, generator=gen)
    zero = lk.lstm_bwd_dwh(h1, torch.ones((1, 256, 1), device=dev), torch.randn((1, 256, 384), device=dev))
    if zero.shape != (128, 384) or bool(zero.any()):
        raise SmokeFailure("dW_h at T=1 is not zeros")
    print("  dW_h at T=1: zeros", flush=True)
    del xz, w_h, g, starts, keep, h, c, h2, c2, hp, cp, dxz, dwh, dxz2, dwh2, pdxz, pdwh, h_prev, dz, red, red_again
    del h1, zero
    # The library yardstick for a whole tower's step at fit-bench's shape (T=32,
    # B=256, D=32 Normal, no starts): cuDNN's LSTM forward + backward against
    # the port's projection + K1, then K2 + dW_h + the projection's autograd.
    tb, tt, td = 256, 32, 32
    x = torch.randn((tb, tt, td), device=dev, generator=gen, requires_grad=True)
    params = {
        "w_x": (torch.randn((td, 4 * td), device=dev, generator=gen) * td**-0.5).requires_grad_(),
        "w_h": (torch.randn((td, 4 * td), device=dev, generator=gen) * td**-0.5).requires_grad_(),
        "b": (torch.randn((4 * td,), device=dev, generator=gen) * 0.1).requires_grad_(),
    }
    g_out = torch.randn((tb, tt, td), device=dev, generator=gen)

    def port_step():
        lk.lstm_apply_kernel(params, x, False).backward(g_out)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = cudnn_lstm({k: v.detach() for k, v in params.items()}, td)
        port_step()
        ours_dx = x.grad.clone()
        x.grad = None
        lib(x)[0].backward(g_out)
        lib_err = float((ours_dx - x.grad).abs().max())
        ours_ms = time_ms(port_step)
        lib_ms = time_ms(lambda: lib(x)[0].backward(g_out))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"  library: torch.nn.LSTM (cuDNN, FP32) forward + backward at fit-bench's tower (T={tt} B={tb} D={td} "
          f"Normal, no starts): {lib_ms:.3f} ms against the port's projection + K1 + K2 + dW_h + autograd "
          f"{ours_ms:.3f} ms ({lib_ms / ours_ms:.2f}x the port's time); dx differs by at most {lib_err:.3e}",
          flush=True)
    if not lib_err <= 1e-3:
        raise SmokeFailure(f"cuDNN's LSTM backward is not the same function here: max diff {lib_err:.3e}")
    del x, params, g_out, lib, ours_dx
    torch.cuda.empty_cache()

    def check_k3(label, rows, reps, lo, n, group):
        """Both K3 routes against the plain version: the FP32 kernel within
        TOL_SCORE and equal to the FP32 K4's group maxima bit for bit, the
        3xTF32 kernel within the certificate's eps of each user and within
        tol_score(cc), equal to the 3xTF32 K4's group maxima bit for bit (the
        same arithmetic; a maximum rounds nothing), with the reps split in
        the call or beforehand by split_reps. Returns ``{name: err}``."""
        want = tk._pad_to(tk.score_groupmax_plain(rows, reps, lo, n, group), tk.groupmax_rows(rows.shape[0], group))
        sub = 8 if group > 8 else None
        fp32 = tk.score_groupmax_fp32(rows, reps, lo, n, group)
        err_fp32 = compare(f"K3 FP32 {label}", fp32, want, TOL_SCORE, quiet=True)
        tc = tk.score_groupmax(rows, reps, lo, n, group)
        if not torch.equal(tc, tk.score_groupmax(rows, reps, lo, n, group, split=tk.split_reps(reps, rows.dtype))):
            raise SmokeFailure(f"K3 3xTF32 {label}: the pre-split reps give other maxima")
        err = compare(f"K3 3xTF32 {label}", tc, want, tol_score(rows.shape[1]), quiet=True)
        ratio = within_eps(f"K3 3xTF32 {label}", tc, want, tk.phase1_error_bound(rows, reps))
        same = ""
        if sub is not None:
            if not torch.equal(fp32, tk.score_submax_groupmax_fp32(rows, reps, lo, n, sub, group)[1]):
                raise SmokeFailure(f"K3 FP32 {label}: not the FP32 K4's group maxima")
            if not torch.equal(tc, tk.score_submax_groupmax(rows, reps, lo, n, sub, group)[1]):
                raise SmokeFailure(f"K3 3xTF32 {label}: not the 3xTF32 K4's group maxima")
            same = "; both equal to K4's group maxima"
        print(f"  K3 {label}: 3xTF32 max_abs_err {err:.3e} (tol {tol_score(rows.shape[1]):.0e}), at most "
              f"{ratio:.4f} x eps, the same with split_reps; FP32 {err_fp32:.3e} (tol {TOL_SCORE:.0e}){same}",
              flush=True)
        return {"score_groupmax": err, "score_groupmax_fp32": err_fp32}

    def time_k3(rows, reps, lo, n, group):
        """Both K3 routes and the plain version by CUDA events; the 3xTF32
        route as the merge calls it, with the reps split once."""
        split = tk.split_reps(reps, rows.dtype)
        ms = {
            "3xTF32": time_ms(lambda: tk.score_groupmax(rows, reps, lo, n, group, split=split)),
            "FP32": time_ms(lambda: tk.score_groupmax_fp32(rows, reps, lo, n, group)),
            "plain": time_ms(lambda: tk.score_groupmax_plain(rows, reps, lo, n, group)),
        }
        print(f"  K3 time at {rows.shape[0]} rows x U={reps.shape[0]}, group {group}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f" (3xTF32 at {ms['3xTF32'] / ms['FP32']:.1%} of FP32)", flush=True)
        return ms

    def check_k4(label, rows, reps, lo, n, sub, group, timed):
        """Both K4 routes against the plain version: the FP32 kernel within
        TOL_SCORE, the 3xTF32 kernel within the certificate's eps of each
        user (phase1_error_bound) and within tol_score(cc). Returns
        ``{name: max_abs_err}``."""
        ps, pg = tk.score_submax_groupmax_plain(rows, reps, lo, n, sub, group)
        eps = tk.phase1_error_bound(rows, reps)
        tol = tol_score(rows.shape[1])
        errs = {}
        for name, fn in (("score_submax_groupmax_fp32", tk.score_submax_groupmax_fp32),
                         ("score_submax_groupmax", tk.score_submax_groupmax)):
            tc = name == "score_submax_groupmax"
            smax, gmax = fn(rows, reps, lo, n, sub, group)
            err, ratio = 0.0, 0.0
            for part, got, want in (("submax", smax, ps), ("groupmax", gmax, pg)):
                want = tk._pad_to(want, got.shape[0])
                err = max(err, compare(f"K4 {'3xTF32' if tc else 'FP32'} {label} {part}", got, want,
                                       tol if tc else TOL_SCORE, quiet=True))
                if tc:
                    ratio = max(ratio, within_eps(f"K4 3xTF32 {label} {part}", got, want, eps))
            print(f"  K4 {'3xTF32' if tc else 'FP32'} {label}: max_abs_err {err:.3e} (tol "
                  f"{tol if tc else TOL_SCORE:.0e})" + (f", at most {ratio:.4f} x eps" if tc else ""), flush=True)
            errs[name] = err
        if timed:
            ms = {name: time_ms(lambda: fn(rows, reps, lo, n, sub, group)) for name, fn in (
                ("FP32", tk.score_submax_groupmax_fp32), ("3xTF32", tk.score_submax_groupmax),
                ("plain", tk.score_submax_groupmax_plain))}
            print("  time: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
        return errs

    print(f"phase 3 K3/K4: one serve chunk {SERVE_CHUNK} x U={USERS}, Cc={DIM + 1}", flush=True)
    rows32 = torch.randn((SERVE_CHUNK, DIM + 1), device=dev, generator=gen)
    reps = torch.randn((USERS, DIM + 1), device=dev, generator=gen) * (DIM + 1) ** -0.5
    lo_mid = 5 * SERVE_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        rows = rows32.to(dtype)
        name = str(dtype).replace("torch.", "")
        for k3, e in check_k3(f"{name} group 128", rows, reps, lo_mid, N_ITEMS, 128).items():
            record(k3, e)
        for k4, e in check_k4(f"{name} 32/128", rows, reps, lo_mid, N_ITEMS, 32, 128, True).items():
            record(k4, e)
    # K3 as the running merge calls it: one chunk x 4096 users (serve-50M-merge,
    # the report's shape) and x 512 users (phase 5).
    for u in (USERS, USERS_MERGE):
        reps_m = reps[:u].contiguous()
        ms = time_k3(rows32, reps_m, lo_mid, N_ITEMS_50M, 128)
        if u == USERS:
            work = (2.0 * SERVE_CHUNK * u * (DIM + 1),
                    nbytes(rows32, reps_m) + tk.groupmax_rows(SERVE_CHUNK, 128) * u * 4)
            record("score_groupmax", 0.0, ms["3xTF32"], ms["plain"], work=work, tf32_products=3)
            record("score_groupmax_fp32", 0.0, ms["FP32"], ms["plain"], work=work)
    # Ragged slabs: mid-catalog (lo + c < n) and past the catalog end; the
    # other subgroup widths of the 3xTF32 epilogue (8: two maxima a warp).
    ragged = rows32[4096 : 4096 + 100_000]
    for lo, n in ((4096, N_ITEMS_MERGE), (4096, 50_000)):
        label = f"ragged c=100000 lo={lo} n={n}"
        for k3, e in check_k3(label, ragged, reps, lo, n, 128).items():
            record(k3, e)
        for k4, e in check_k4(label, ragged, reps, lo, n, 32, 128, False).items():
            record(k4, e)
    for sub, group in ((8, 32), (16, 64), (64, 128)):
        for k4, e in check_k4(f"ragged {sub}/{group}", ragged, reps[:300].contiguous(), 4096, 50_000, sub, group,
                              False).items():
            record(k4, e)
    for group in (8, 32):
        for k3, e in check_k3(f"ragged group {group}", ragged, reps[:300].contiguous(), 4096, 50_000, group).items():
            record(k3, e)
    del rows32, rows, reps, reps_m, ragged
    # The other widths take the 3xTF32 tile's other routes (as K5's below).
    for cc, c, u in ((33, 50_001, 13), (301, 30_000, 300), (512, 20_000, 300)):
        rows32 = torch.randn((c, cc), device=dev, generator=gen)
        reps = (torch.randn((u, cc), device=dev, generator=gen) * cc**-0.5).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            for k4, e in check_k4(f"{name} Cc={cc} c={c} U={u}", rows32.to(dtype), reps, 5, c - 1, 32, 128,
                                  False).items():
                record(k4, e)
            for k3, e in check_k3(f"{name} Cc={cc} c={c} U={u}", rows32.to(dtype), reps, 5, c - 1, 128).items():
                record(k3, e)
    del rows32, reps
    # The bound against the card's arithmetic: all-positive rows and reps, so
    # that no cancellation hides the error, one nonzero row in 16 so that each
    # subgroup maximum (K4, sub 16) and each group maximum (K3, group 16) is
    # that row's 3xTF32 score; the largest error against the float64 dot,
    # over sum_k |reps_k| M_k, beside the phase-1 part of gamma (split +
    # truncating accumulation) and gamma itself. K3's arithmetic is K4's, so
    # one bound holds both.
    print("phase 3 K3/K4 3xTF32 error on all-positive inputs against the stated bound", flush=True)
    for cc in (33, 128, 512):
        for dtype in (torch.float32, torch.bfloat16):
            c = 32768
            rows = torch.zeros((c, cc), device=dev)
            rows[::16] = torch.rand((c // 16, cc), device=dev, generator=gen) * 0.5 + 0.5
            rows = rows.to(dtype)
            rp = (torch.rand((256, cc), device=dev, generator=gen) * 0.5 + 0.5).contiguous()
            smax, _ = tk.score_submax_groupmax(rows, rp, 0, c, 16, 32)
            gmax = tk.score_groupmax(rows, rp, 0, c, 16)
            exact = rows[::16].double() @ rp.double().T
            scale = rp.double() @ rows.float().abs().amax(dim=0).double()
            gamma = tk.phase1_gamma(cc, dtype, tensor_cores=True)
            gamma1 = gamma - tk._gamma_fp32(cc)
            name = str(dtype).replace("torch.", "")
            for kernel, got in (("K4", smax), ("K3", gmax)):
                ratio = float(((got[: c // 16].double() - exact).abs() / scale).max())
                print(f"  {kernel} cc={cc} {name}: largest |s - s_fp64| / (sum |reps| M) {ratio:.3e}; phase-1 "
                      f"gamma {gamma1:.3e} ({ratio / gamma1:.1%} of it), gamma {gamma:.3e}", flush=True)
                if not ratio <= gamma1:
                    raise SmokeFailure(f"{kernel} 3xTF32 cc={cc} {name}: error {ratio:.3e} above its bound {gamma1:.3e}")
    del rows, rp, smax, gmax, exact, scale
    torch.cuda.empty_cache()
    k4_tile_phase()

    def check_k5(label, rows, reps, lo, col_lo, n, timed):
        """K5 against its plain version: targets are real row scores plus
        noise of 1e-4, so that many rows sit near them. The probe scores
        agree within TOL_SCORE; each user's count may differ from the plain
        one by at most its rows whose plain score lies within TOL_SCORE of
        its target."""
        c, u = rows.shape[0], reps.shape[0]
        st = rows.float() @ reps.T  # the plain formulation's scores
        users = torch.arange(u, device=dev)
        pick = torch.randint(0, c, (u,), device=dev, generator=gen)
        targets = (st[pick, users] + 1e-4 * torch.randn((u,), device=dev, generator=gen)).contiguous()
        probe = torch.randint(-2, c + 2, (u,), device=dev, generator=gen)
        counts, probe_sc = tk.score_count_ge(rows, reps, targets, probe, lo, col_lo, n)
        p_counts, p_probe = tk.score_count_ge_plain(rows, reps, targets, probe, lo, col_lo, n)
        local = torch.arange(c, device=dev)
        valid = ((lo + local) < n) & (local >= col_lo)
        near = (((st - targets).abs() <= TOL_SCORE) & valid[:, None]).sum(dim=0)
        del st
        diff = (counts.long() - p_counts.long()).abs()
        err = float((probe_sc - p_probe).abs().max())
        print(
            f"  K5 {label}: probe max_abs_err {err:.3e} (tol {TOL_SCORE:.0e}); counts differ for "
            f"{int((diff > 0).sum())} of {u} users, by at most {int(diff.max())} (near-tie rows "
            f"per user up to {int(near.max())}); counts {int(p_counts.min())}..{int(p_counts.max())}",
            flush=True,
        )
        if not err <= TOL_SCORE:
            raise SmokeFailure(f"K5 {label}: probe error {err:.3e} above {TOL_SCORE:.0e}")
        if bool((diff > near).any()):
            raise SmokeFailure(f"K5 {label}: counts differ beyond the near-tie rows")
        if timed:
            ms = time_ms(lambda: tk.score_count_ge(rows, reps, targets, probe, lo, col_lo, n))
            plain_ms = time_ms(lambda: tk.score_count_ge_plain(rows, reps, targets, probe, lo, col_lo, n))
            print(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        return err

    print(f"phase 3 K5 score_count_ge: {K5_ROWS} x U={USERS_MERGE}, Cc={DIM + 1}", flush=True)
    rows32 = torch.randn((K5_ROWS, DIM + 1), device=dev, generator=gen)
    reps = (torch.randn((USERS_MERGE, DIM + 1), device=dev, generator=gen) * (DIM + 1) ** -0.5).contiguous()
    record("score_count_ge", check_k5("float32 whole catalog", rows32, reps, 0, 0, K5_ROWS, True))
    record("score_count_ge", check_k5(
        "bfloat16 whole catalog", rows32.to(torch.bfloat16), reps, 0, 0, K5_ROWS, False
    ))
    # A mid-catalog slab: lo > 0, col_lo > 0, ragged c, n cutting through it.
    slab = rows32[123_456 : 123_456 + 300_001]
    record("score_count_ge", check_k5(
        "slab c=300001 lo=2000000 col_lo=1000 n=2250000", slab, reps, 2_000_000, 1000, 2_250_000, False
    ))
    del rows32, reps, slab
    # Other widths take K5's other routes: plain loads where a row is not a
    # whole number of 16-byte pieces (33, 301), and rows staged slice by
    # slice where they do not fit shared memory for all user tiles (301, 512).
    for cc, c, u in ((33, 50_001, 13), (301, 30_000, 300), (512, 20_000, 300)):
        rows32 = torch.randn((c, cc), device=dev, generator=gen)
        reps = (torch.randn((u, cc), device=dev, generator=gen) * cc**-0.5).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            label = f"{name} Cc={cc} c={c} U={u}"
            record("score_count_ge", check_k5(label, rows32.to(dtype), reps, 5, 7, c - 1, False))
    del rows32, reps
    torch.cuda.empty_cache()

    def check_equal(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            raise SmokeFailure(f"{name}: not equal to the plain version")
        print(f"  {name}: equal to the plain version, bit for bit", flush=True)

    def cycling(fn, sets):
        """``fn`` called on the next of ``sets`` at each call."""
        it = itertools.cycle(sets)
        return lambda: fn(next(it))

    def check_cand(label, name, fn, haug, table, cand, timed, cold=False):
        """P3/P4 against the plain gather + einsum, within TOL_REL of the
        largest score; with ``timed``, device times and the bound (each
        distinct row read once), over COLD_SETS candidate sets in turn when
        ``cold``."""
        got = fn(haug, table, cand)
        want = rowk.cand_score_plain(haug, table, cand)
        err = compare_rel(f"{name} {label}", got, want, TOL_REL)
        if timed:
            sets = [cand] + [torch.randint_like(cand, table.shape[0], generator=gen) for _ in range(COLD_SETS - 1)]
            sets = sets if cold else [cand]
            ms = device_ms(cycling(lambda c: fn(haug, table, c), sets))
            plain_ms = device_ms(cycling(lambda c: rowk.cand_score_plain(haug, table, c), sets))
            print(f"  device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  f"{f' ({COLD_SETS} candidate sets in turn)' if cold else ''}", flush=True)
            rows = int(torch.unique(cand).numel())
            (p, k), c = cand.shape, table.shape[1]
            record(name, err, ms, plain_ms, work=(
                2.0 * p * k * c, rows * c * table.element_size() + nbytes(haug, cand, got),
            ))
        else:
            record(name, err)

    print(
        f"phase 3 P1/P2/P4 on the sparse step's tables: {N_ITEMS} x {DIM + 1} f32 and "
        f"{N_ITEMS_BF16} x {DIM + 1} bf16, M={ROWS_M} sorted unique rows, P={CAND_P} x K={CAND_K}",
        flush=True,
    )
    for n_rows, dtype in ((N_ITEMS, torch.float32), (N_ITEMS_BF16, torch.bfloat16)):
        name = str(dtype).replace("torch.", "")
        timed = dtype == torch.float32  # the probe's f32 shape is the one reported
        table = torch.randn((n_rows, DIM + 1), device=dev, generator=gen, dtype=dtype)
        ids = torch.randperm(n_rows, generator=gen, device=dev)[:ROWS_M].sort().values
        check_equal(f"P1 gather_rows {name}", rowk.gather_rows(table, ids), rowk.gather_rows_plain(table, ids))
        edges = torch.tensor([-5, 0, n_rows - 1, n_rows, n_rows + 7, 2**40], device=dev)  # clamped
        check_equal(f"P1 gather_rows {name}, ids outside the table", rowk.gather_rows(table, edges),
                    rowk.gather_rows_plain(table, edges))
        # P2 as sparse_update calls it: the live rows with the dropped
        # sentinel N between them, and deltas already in the table's dtype.
        slots = torch.full((2 * ROWS_M,), n_rows, dtype=torch.int64, device=dev)
        slots[1::2] = ids
        delta = (torch.randn((2 * ROWS_M, DIM + 1), device=dev, generator=gen) * 1e-3).to(dtype)
        got, want = table.clone(), table.clone()
        rowk.scatter_add_rows_(got, slots, delta)
        rowk.scatter_add_rows_plain(want, slots, delta)
        check_equal(f"P2 scatter_add_rows {name} (sentinels interleaved), whole table", got, want)
        moved = int((got != table).any(dim=1).sum())
        if moved > ROWS_M or moved < ROWS_M * 0.99:
            raise SmokeFailure(f"P2 {name}: {moved} rows moved for {ROWS_M} live ids")
        del got, want
        record("gather_rows", 0.0)
        record("scatter_add_rows", 0.0)
        if timed:
            row_bytes = ROWS_M * (DIM + 1) * table.element_size()
            sets = [ids] + [
                torch.randperm(n_rows, generator=gen, device=dev)[:ROWS_M].sort().values
                for _ in range(COLD_SETS - 1)
            ]
            ms = device_ms(cycling(lambda i: rowk.gather_rows(table, i), sets))
            plain_ms = device_ms(cycling(lambda i: rowk.gather_rows_plain(table, i), sets))
            lib_ms = device_ms(cycling(lambda i: table.index_select(0, i), sets))
            warm_ms = device_ms(lambda: rowk.gather_rows(table, ids))
            print(f"  P1 device time over {COLD_SETS} id sets in turn: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"index_select {lib_ms:.4f} ms; kernel on one id set (rows in L2) {warm_ms:.4f} ms", flush=True)
            record("gather_rows", 0.0, ms, plain_ms, work=(0.0, 2 * row_bytes + nbytes(ids)), library_ms=lib_ms)
            g = delta[1::2].contiguous()  # the live rows' deltas: the probe's function
            ms = device_ms(cycling(lambda i: rowk.scatter_add_rows_(table, i, g), sets))
            plain_ms = device_ms(cycling(lambda i: rowk.scatter_add_rows_plain(table, i, g), sets))
            lib_ms = device_ms(cycling(lambda i: table.index_add_(0, i, g), sets))
            warm_ms = device_ms(lambda: rowk.scatter_add_rows_(table, ids, g))
            print(f"  P2 device time over {COLD_SETS} id sets in turn: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"index_add_ {lib_ms:.4f} ms; kernel on one id set (rows in L2) {warm_ms:.4f} ms", flush=True)
            record("scatter_add_rows", 0.0, ms, plain_ms, work=(
                float(g.numel()), 3 * row_bytes + nbytes(ids),
            ), library_ms=lib_ms)
            del g
        haug = torch.randn((CAND_P, DIM + 1), device=dev, generator=gen) * (DIM + 1) ** -0.5
        cand = torch.randint(0, n_rows, (CAND_P, CAND_K), device=dev, generator=gen)
        check_cand(f"{name} {n_rows} x {DIM + 1}", "cand_score_rows", rowk.cand_score_rows, haug, table, cand,
                   timed, cold=True)
        del table, ids, slots, delta, haug, cand
        torch.cuda.empty_cache()

    print(
        "phase 3 P3/P4 at fit-bench's table (1682 x 33, f32 and bf16: 222,024 and 111,012 bytes, neither a "
        "multiple of 16), a view of it one row in (not on a 16-byte boundary), a 1000 x 32 table (a multiple "
        "of 16), a 3 x 5 one, the probe's (1688 x 128) and rows wider than a warp's registers hold "
        f"(80 and 4000 x 640), P={P3_POSITIONS} x K={CAND_K}", flush=True,
    )
    for n_rows, c, dtype, offset in (
        (BENCH_ITEMS, 33, torch.float32, 0), (BENCH_ITEMS, 33, torch.bfloat16, 0),
        (BENCH_ITEMS, 33, torch.float32, 1), (BENCH_ITEMS, 33, torch.bfloat16, 3), (1000, 32, torch.float32, 0),
        (3, 5, torch.float32, 1), (1688, 128, torch.float32, 0), (80, 640, torch.float32, 0),
        (4000, 640, torch.bfloat16, 0),
    ):
        name = str(dtype).replace("torch.", "")
        table, haug, cand = cand_inputs(n_rows, c, dtype, offset, dev, gen)
        label = f"{name} {n_rows} x {c}" + (f", {table.data_ptr() % 16} bytes past a 16-byte boundary"
                                             if table.data_ptr() % 16 else "")
        fits = rowk.cand_score_fits_smem(table)
        if fits:
            check_cand(label, "cand_score_smem", rowk.cand_score_smem, haug, table, cand,
                       timed=(c, dtype, offset) == (33, torch.float32, 0))
        check_cand(label, "cand_score_rows", rowk.cand_score_rows, haug, table, cand, timed=False)
        ms = {"P4": device_ms(lambda: rowk.cand_score_rows(haug, table, cand))}
        if fits and n_rows > 3:
            ms["P3"] = device_ms(lambda: rowk.cand_score_smem(haug, table, cand))
        print(f"  {label}, device time: " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in ms.items()), flush=True)
    del table, haug, cand
    torch.cuda.empty_cache()

    # -- phase 4: the serving path at 10M items ------------------------------------
    mark("phase 4")
    t0 = time.perf_counter()
    model = serving_model(N_ITEMS, dev)
    torch.cuda.synchronize()
    histories = serving_histories(N_ITEMS)
    print(
        f"phase 4 model: {N_ITEMS} items, LSTM-{DIM} Normal, f32 table, built in "
        f"{time.perf_counter() - t0:.1f} s; {USERS} histories of 2-31 items", flush=True,
    )
    table = model._params["item_table"]

    # K4 at the shape the serving path gives it (the whole catalog), on the
    # model's own table and representations: the 3xTF32 kernel against the
    # plain version chunk by chunk (a whole [10M, 4096] score matrix would be
    # 164 GB), within TOL_SCORE and the certificate's eps, then timed beside
    # the FP32 kernel on the same inputs.
    reps = torch.from_numpy(
        np.stack([u.user_embedding for u in model.user_representations(histories)])
    ).to(dev)
    reps_aug = torch.cat([reps, reps.new_ones((USERS, 1))], dim=1).contiguous()
    smax, gmax = tk.score_submax_groupmax(table, reps_aug, 0, N_ITEMS, 32, 128)
    eps = tk.phase1_error_bound(table, reps_aug)
    err, ratio = 0.0, 0.0
    for lo in range(0, N_ITEMS, SERVE_CHUNK):
        ps, pg = tk.score_submax_groupmax_plain(table[lo : lo + SERVE_CHUNK], reps_aug, lo, N_ITEMS, 32, 128)
        s0, g0 = lo // 32, lo // 128
        for part, got, want in (("submax", smax[s0 : s0 + ps.shape[0]], ps), ("groupmax", gmax[g0 : g0 + pg.shape[0]], pg)):
            err = max(err, compare(f"K4 {part} rows {lo}+", got, want, TOL_SCORE, quiet=True))
            ratio = max(ratio, within_eps(f"K4 {part} rows {lo}+", got, want, eps))
    if not (torch.isinf(smax[-(smax.shape[0] - (N_ITEMS + 31) // 32):]).all()):
        raise SmokeFailure("K4 whole catalog: pad rows are not -inf")
    k4_work = (2.0 * N_ITEMS * USERS * (DIM + 1), nbytes(table, reps_aug, smax, gmax))
    del smax, gmax
    ms = time_ms(lambda: tk.score_submax_groupmax(table, reps_aug, 0, N_ITEMS, 32, 128), reps=3)
    fp32_ms = time_ms(lambda: tk.score_submax_groupmax_fp32(table, reps_aug, 0, N_ITEMS, 32, 128), reps=3)

    def plain_whole():
        for lo in range(0, N_ITEMS, SERVE_CHUNK):
            tk.score_submax_groupmax_plain(table[lo : lo + SERVE_CHUNK], reps_aug, lo, N_ITEMS, 32, 128)

    plain_ms = time_ms(plain_whole, reps=3)
    eps_ms = time_ms(lambda: tk.phase1_error_bound(table, reps_aug), reps=3)
    print(
        f"  K4 whole catalog {N_ITEMS} x U={USERS}, sub 32 / group 128: 3xTF32 max_abs_err {err:.3e} "
        f"(tol {TOL_SCORE:.0e}), at most {ratio:.4f} x eps (eps {float(eps.min()):.3e}..{float(eps.max()):.3e}); "
        f"3xTF32 kernel {ms:.1f} ms, FP32 kernel {fp32_ms:.1f} ms on the same inputs (3xTF32 at "
        f"{ms / fp32_ms:.1%} of it), plain (chunked) {plain_ms:.1f} ms; the bound eps itself {eps_ms:.2f} ms",
        flush=True,
    )
    record("score_submax_groupmax", err, ms, plain_ms, work=k4_work, tf32_products=3)
    record("score_submax_groupmax_fp32", 0.0, fp32_ms, plain_ms, work=k4_work)
    del reps, reps_aug, eps
    torch.cuda.empty_cache()

    # The main path: every launch counter from 0, then the entry points.
    counters = {
        "lstm_fwd": lk.lstm_fwd,
        "lstm_bwd": lk.lstm_bwd,
        "lstm_bwd_dwh": lk.lstm_bwd_dwh,
        "score_groupmax": tk.score_groupmax,
        "score_groupmax_fp32": tk.score_groupmax_fp32,
        "score_submax_groupmax": tk.score_submax_groupmax,
        "score_submax_groupmax_fp32": tk.score_submax_groupmax_fp32,
        "score_count_ge": tk.score_count_ge,
        "gather_rows": rowk.gather_rows,
        "scatter_add_rows": rowk.scatter_add_rows_,
        "cand_score_smem": rowk.cand_score_smem,
        "cand_score_rows": rowk.cand_score_rows,
    }
    serving_kernels = (
        "lstm_fwd", "score_groupmax", "score_groupmax_fp32", "score_submax_groupmax", "score_submax_groupmax_fp32",
    )
    merge_kernels = ("lstm_fwd", "score_groupmax")  # serve-50M-merge: no user rechecked there
    eval_kernels = ("lstm_fwd", "score_count_ge")
    training_kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_dwh", "gather_rows")
    warp_kernels = training_kernels + ("cand_score_smem",)  # fit-bench: the table fits shared memory
    sparse_kernels = training_kernels + ("scatter_add_rows", "cand_score_rows")
    launches = dict.fromkeys(counters, 0)  # summed over the main-path runs
    launches_by_path = {name: {} for name in counters}  # kernel -> {path: launches}
    lstm_kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_dwh")

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters(path, kernels, absent=()):
        """Fail unless each of ``kernels`` launched since the counters were
        zeroed and none of ``absent`` did; add the counts to the totals."""
        got = {name: counters[name].launches for name in counters}
        print(f"launches on the {path}: {got}", flush=True)
        for name in kernels:
            if got[name] <= 0:
                raise SmokeFailure(f"the {path} never launched {name}")
        for name in absent:
            if got[name]:
                raise SmokeFailure(f"the {path} launched {name} {got[name]} times")
        for name, count in got.items():
            launches[name] += count
            if count:
                launches_by_path[name][path] = count

    floors = (base.MERGE_BUFFER_FLOOR, base.SUBMAX_BUFFER_FLOOR, base.PHASE2_BUFFER_FLOOR)
    if tuple(CONSTANT_BUDGETS.values()) != floors:
        raise SmokeFailure(f"the constants' side {CONSTANT_BUDGETS} is not the port's floors {floors}")
    budget_cells = {}  # cell -> {side: budgets, route, users/s}
    zero_counters()
    model.recommend_batch(histories, k=K)  # warm-up
    topk_streamed.rechecked_users = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ids, vals = model.recommend_batch(histories, k=K, return_scores=True)
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    print(
        f"phase 4 recommend_batch k={K}: {USERS / t_med:.1f} users/s (median of 3: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per batch of {USERS}); the certificate sent "
        f"{topk_streamed.rechecked_users / 3:g} of {USERS} users a batch to the FP32 K4", flush=True,
    )
    # The caller's TF32 flag on: the serving path keeps its FP32 matmuls and
    # the flag.
    torch.backends.cuda.matmul.allow_tf32 = True
    ids_tf32, vals_tf32 = model.recommend_batch(histories, k=K, return_scores=True)
    flag_kept = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    if not flag_kept or ids_tf32 != ids or not np.array_equal(vals_tf32, vals):
        raise SmokeFailure(f"phase 4: with allow_tf32 True the batch differs or the flag changed ({flag_kept})")
    print("  phase 4 with the caller's allow_tf32 True: the same ids and scores, the flag left True", flush=True)
    budget_cells["serve-10M"] = budget_sides("phase 4 serve-10M", model, histories)
    third = serve_side(
        "phase 4 serve-10M", model, histories, "phase2", {"_PHASE2_BUFFER_BYTES": base.PHASE2_BUFFER_FLOOR}
    )
    card = budget_cells["serve-10M"]["card"]
    check_same_lists("phase 4 serve-10M, phase 2's constant against the card's", third["ids"], third["vals"],
                     card["ids"], card["vals"])
    budget_cells["serve-10M"]["phase2"] = third
    t0 = time.perf_counter()
    for _ in range(100):
        base.card_reading(dev)
    t_read = (time.perf_counter() - t0) / 100
    one = histories[0]
    model.recommend(one, k=K)  # warm-up
    one_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.recommend(one, k=K)
        one_times.append(time.perf_counter() - t0)
    t_one = statistics.median(one_times)
    print(f"  phase 4: one reading of the card's memory (base.card_reading) takes {t_read * 1e6:.1f} us of host, "
          f"the device idle; a one-user recommend on serve-10M (which reads the card once) {t_one * 1e3:.3f} ms "
          f"(median of 5: {', '.join(f'{t * 1e3:.3f}' for t in one_times)}), the reading {t_read / t_one:.2%} of it",
          flush=True)
    model_merge = serving_model(N_ITEMS_MERGE, dev)
    model_merge._MERGE_BUFFER_BYTES = 0  # forces the running per-chunk merge
    hist_m = serving_histories(N_ITEMS_MERGE, USERS_MERGE, seed=8)
    before = topk_streamed.rechecked_users
    t0 = time.perf_counter()
    ids_m, vals_m = model_merge.recommend_batch(hist_m, k=K, return_scores=True)
    t_m = time.perf_counter() - t0
    print(f"phase 5 running merge: {N_ITEMS_MERGE} items, U={USERS_MERGE}: {t_m * 1e3:.1f} ms (one call); "
          f"the certificate sent {topk_streamed.rechecked_users - before} of {USERS_MERGE} users to the FP32 K3",
          flush=True)
    model_rep = serving_model(N_ITEMS_MERGE, dev, seed=43)
    tab_rep = model_rep._params["item_table"]
    tab_rep.copy_(tab_rep[: N_ITEMS_MERGE // REPEATS].repeat(REPEATS, 1))  # item i's row at i + j * 10,000
    before = topk_streamed.rechecked_users
    t0 = time.perf_counter()
    ids_r, vals_r = model_rep.recommend_batch(hist_m, k=K, return_scores=True)
    t_r = time.perf_counter() - t0
    rechecked = topk_streamed.rechecked_users - before
    print(f"phase 5b {REPEATS} copies of {N_ITEMS_MERGE // REPEATS} items, U={USERS_MERGE}: {t_r * 1e3:.1f} ms "
          f"(one call); the certificate sent {rechecked} of {USERS_MERGE} users to the FP32 K4", flush=True)
    if rechecked != USERS_MERGE:
        raise SmokeFailure(f"phase 5b: {rechecked} users rechecked, not all {USERS_MERGE}: every top-10 ties")
    model_rep._MERGE_BUFFER_BYTES = 0  # phase 5c: the same catalog through the running merge
    before, fp32_before = topk_streamed.rechecked_users, tk.score_groupmax_fp32.launches
    t0 = time.perf_counter()
    ids_c, vals_c = model_rep.recommend_batch(hist_m, k=K, return_scores=True)
    t_c = time.perf_counter() - t0
    rechecked = topk_streamed.rechecked_users - before
    fp32_calls = tk.score_groupmax_fp32.launches - fp32_before
    print(f"phase 5c the same catalog, running merge, U={USERS_MERGE}: {t_c * 1e3:.1f} ms (one call); the "
          f"certificate sent {rechecked} of {USERS_MERGE} users to the FP32 K3 ({fp32_calls} chunk calls)", flush=True)
    if rechecked != USERS_MERGE or fp32_calls != -(-N_ITEMS_MERGE // SERVE_CHUNK):
        raise SmokeFailure(f"phase 5c: {rechecked} users rechecked in {fp32_calls} FP32 K3 calls, not all "
                           f"{USERS_MERGE} in one call a chunk")
    read_counters("serving path", serving_kernels)

    # -- checks against the plain reference ------------------------------------------
    check_lists("phase 4", ids, histories, N_ITEMS)
    normal_lstm = functools.partial(lstm_apply, coupled=False)
    check_against_reference(
        "phase 4", model, histories[:REF_USERS], ids[:REF_USERS], vals[:REF_USERS], normal_lstm, torch
    )
    check_lists("phase 5", ids_m, hist_m, N_ITEMS_MERGE)
    check_against_reference("phase 5", model_merge, hist_m, ids_m, vals_m, normal_lstm, torch)
    check_lists("phase 5b", ids_r, hist_m, N_ITEMS_MERGE)
    check_against_reference("phase 5b", model_rep, hist_m, ids_r, vals_r, normal_lstm, torch)
    check_lists("phase 5c", ids_c, hist_m, N_ITEMS_MERGE)
    check_against_reference("phase 5c", model_rep, hist_m, ids_c, vals_c, normal_lstm, torch)
    del model_rep, tab_rep, model_merge
    # World size 1's lists, which phase 18c's mesh must serve again.
    served = {"serve-10M": (histories, ids, vals), "serve-1M-merge": (hist_m, ids_m, vals_m),
              "copies": (hist_m, ids_r, vals_r), "copies-merge": (hist_m, ids_c, vals_c)}

    def profiled(label, fn, top):
        """Run ``fn`` once under ``torch.profiler`` and print its wall time,
        the device's busy time (sum of kernel self times), the idle share,
        the kernel launches and the ``top`` kernels by device time. Returns
        ``(wall_ms, busy_ms, launches)``."""
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
        return wall_ms, busy_ms, sum(e.count for e in on_device)

    # -- phase 5d: serve-50M-merge, on each side of the budgets ------------------------
    mark("phase 5d")
    del model, table
    card_memory("phase 5d, the 10M model freed", dev)
    torch.cuda.empty_cache()
    card_memory("phase 5d, after empty_cache", dev)
    t0 = time.perf_counter()
    model_50m = serving_model(N_ITEMS_50M, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    chunks = -(-N_ITEMS_50M // SERVE_CHUNK)
    group_stack = chunks * (SERVE_CHUNK // 128) * USERS * 4
    print(f"phase 5d model: {N_ITEMS_50M} items, LSTM-{DIM} Normal, f32 table "
          f"({model_50m._params['item_table'].numel() * 4 / 1e9:.1f} GB), built in {t_build:.1f} s; the single "
          f"pass wants twice its {group_stack / 1e9:.2f} GB of group maxima, and {4 * group_stack / 1e9:.2f} GB more "
          f"for subgroups of 32, against the constants' {base.MERGE_BUFFER_FLOOR / 2**30:g} GiB", flush=True)
    card_memory("phase 5d, the 50M model built", dev)
    hist_50 = serving_histories(N_ITEMS_50M)

    def after_50m(side, got):
        """Each side's path: the card's budgets take the single pass (K4),
        the constants the running merge (K3, one launch a chunk)."""
        route = got["route"]
        if side == "card":
            if not route["single_pass"]:
                raise SmokeFailure("phase 5d: the card's budgets did not take the single pass at 50M items")
            read_counters("serve-50M path", ("lstm_fwd", "score_submax_groupmax" if route["sub"] < route["group"]
                                             else "score_groupmax"))
        else:
            if route["single_pass"]:
                raise SmokeFailure("phase 5d: the constants' budget took the single pass; the running merge would not run")
            read_counters("serve-50M-merge path", merge_kernels)
            if tk.score_groupmax.launches != 4 * chunks:
                raise SmokeFailure(f"phase 5d: {tk.score_groupmax.launches} K3 launches for 4 batches of {chunks} chunks")
        profiled(f"phase 5d profile, one batch at {N_ITEMS_50M} items, {SIDE_NAMES[side]}",
                 lambda: model_50m.recommend_batch(hist_50, k=K), top=10)
        zero_counters()

    zero_counters()
    sides = budget_sides("phase 5d serve-50M-merge", model_50m, hist_50, after=after_50m)
    budget_cells["serve-50M-merge"] = sides
    ids_50, vals_50 = sides["card"]["ids"].tolist(), sides["card"]["vals"]
    check_lists("phase 5d", ids_50, hist_50, N_ITEMS_50M)
    check_against_reference(
        "phase 5d", model_50m, hist_50[:REF_USERS], ids_50[:REF_USERS], vals_50[:REF_USERS], normal_lstm, torch
    )
    del model_50m, sides
    torch.cuda.empty_cache()

    # -- phase 5e: serve-20M-bf16 (benches/serving.py items20m_bf16), each side ----------
    mark("phase 5e")
    t0 = time.perf_counter()
    model_20m = serving_model(N_ITEMS_BF16, dev, dtype="bfloat16")
    torch.cuda.synchronize()
    print(f"phase 5e model: {N_ITEMS_BF16} items, LSTM-{DIM} Normal, bf16 table "
          f"({model_20m._params['item_table'].numel() * 2 / 1e9:.2f} GB), built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    hist_20 = serving_histories(N_ITEMS_BF16)
    zero_counters()
    sides = budget_sides(
        "phase 5e serve-20M-bf16", model_20m, hist_20,
        after=lambda side, got: profiled(f"phase 5e profile, one batch at {N_ITEMS_BF16} items, {SIDE_NAMES[side]}",
                                         lambda: model_20m.recommend_batch(hist_20, k=K), top=6),
    )
    read_counters("serve-20M-bf16 path", ("lstm_fwd", "score_submax_groupmax"))
    budget_cells["serve-20M-bf16"] = sides
    ids_20, vals_20 = sides["card"]["ids"].tolist(), sides["card"]["vals"]
    check_lists("phase 5e", ids_20, hist_20, N_ITEMS_BF16)
    check_against_reference(
        "phase 5e", model_20m, hist_20[:REF_USERS], ids_20[:REF_USERS], vals_20[:REF_USERS], normal_lstm, torch
    )
    del model_20m, sides
    torch.cuda.empty_cache()
    print(json.dumps({"serving_budgets": {
        cell: {side: {k: v for k, v in got.items() if k not in ("ids", "vals")} for side, got in sides.items()}
        for cell, sides in budget_cells.items()
    }}), flush=True)
    model = serving_model(N_ITEMS, dev)  # phase 4's model again, for the profile and the evaluation path
    table = model._params["item_table"]

    # -- phase 6: where a batch's device time goes (a separate traced run) ----------
    mark("phase 6")
    profiled(
        f"phase 6 profile, one batch at {N_ITEMS} items",
        lambda: model.recommend_batch(histories, k=K), top=8,
    )
    torch.cuda.empty_cache()

    # -- phase 6b: the evaluation path at 10M items ----------------------------------
    mark("phase 6b")
    tests = {u: eval_test(u) for u in EVAL_USERS}
    zero_counters()
    mrr_calls = 0
    for u, test in tests.items():
        evaluation.mrr_score(model, test)  # warm-up
        times, mrrs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            mrrs.append(evaluation.mrr_score(model, test))
            times.append(time.perf_counter() - t0)
        mrr_calls += 4
        t_med = statistics.median(times)
        print(
            f"phase 6b eval {N_ITEMS} items, U={u}: {t_med * 1e6 / u:.1f} us per user (median of 3: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms), MRR {mrrs[0]:.6f}", flush=True,
        )
        if not all(np.isfinite(m) and 0 < m <= 1 for m in mrrs):
            raise SmokeFailure(f"phase 6b: MRR {mrrs} outside (0, 1]")
    read_counters("evaluation path", eval_kernels)
    if tk.score_count_ge.launches != mrr_calls:  # one user batch per call
        raise SmokeFailure(f"phase 6b: {tk.score_count_ge.launches} K5 launches for {mrr_calls} calls")
    profiled(
        f"phase 6b profile, one eval at {N_ITEMS} items, U={EVAL_USERS[-1]}",
        lambda: evaluation.mrr_score(model, tests[EVAL_USERS[-1]]), top=10,
    )

    # K5 at the shapes the evaluation path gives it (the whole catalog, each
    # test set's users), against its plain version chunk by chunk (a [10M,
    # 4096] score matrix would be 164 GB), with the near-tie rule of phase 3.
    # The report keeps the 4096-user call.
    for test in tests.values():
        users = np.flatnonzero(np.diff(test.user_pointers) >= 2)
        reps, _, test_items, test_in_prefix = evaluation._batch_inputs(model, test, users, N_ITEMS)
        targets = evaluation._targets(table, reps, test_items, test_in_prefix)
        reps_aug = torch.cat([reps, reps.new_ones((len(users), 1))], dim=1).contiguous()
        counts, _ = tk.score_count_ge(table, reps_aug, targets, test_items, 0, 0, N_ITEMS)

        def plain_whole():
            return [
                tk.score_count_ge_plain(table[lo : lo + SERVE_CHUNK], reps_aug, targets, test_items - lo,
                                        lo, 0, N_ITEMS)[0]
                for lo in range(0, N_ITEMS, SERVE_CHUNK)
            ]

        p_counts = torch.stack(plain_whole()).sum(dim=0)
        near = sum(
            ((table[lo : lo + SERVE_CHUNK] @ reps_aug.T - targets).abs() <= TOL_SCORE).sum(dim=0)
            for lo in range(0, N_ITEMS, SERVE_CHUNK)
        )
        diff = (counts.long() - p_counts.long()).abs()
        if bool((diff > near).any()):
            raise SmokeFailure("phase 6b: K5 counts differ from the plain version beyond the near-tie rows")
        ms = time_ms(lambda: tk.score_count_ge(table, reps_aug, targets, test_items, 0, 0, N_ITEMS), reps=3)
        plain_ms = time_ms(plain_whole, reps=3)
        print(
            f"  K5 whole catalog {N_ITEMS} x U={len(users)}: counts differ for {int((diff > 0).sum())} "
            f"users, by at most {int(diff.max())} (near-tie rows per user up to {int(near.max())}); "
            f"kernel {ms:.1f} ms, plain (chunked) {plain_ms:.1f} ms", flush=True,
        )
        record("score_count_ge", 0.0, ms, plain_ms, work=(
            2.0 * N_ITEMS * len(users) * (DIM + 1),
            nbytes(table, reps_aug, targets, test_items) + len(users) * 8,  # counts and probe out
        ), tf32_products=3 if table.dtype == torch.float32 else 2)
        del reps, reps_aug, targets, test_items, test_in_prefix, counts, p_counts, near, diff

    # 64 users' ranks against the per-user predict loop.
    test = tests[EVAL_USERS[0]]
    ptr = test.user_pointers
    sub = sbr_data.CompressedInteractions(
        EVAL_REF_USERS, N_ITEMS, ptr[: EVAL_REF_USERS + 1], test.item_ids[: ptr[EVAL_REF_USERS]],
        test.timestamps[: ptr[EVAL_REF_USERS]],
    )
    t0 = time.perf_counter()
    generic = evaluation._ranks_generic(model, sub)
    t_gen = time.perf_counter() - t0
    check_ranks("phase 6b", model, sub, {"batched (K5)": evaluation._ranks_batched(model, sub)}, generic, torch)
    print(f"  per-user loop: {t_gen:.1f} s for {EVAL_REF_USERS} users", flush=True)
    del model, table, tests, test, sub
    torch.cuda.empty_cache()

    # -- phase 6c: fused counter against chunked counter, 200,000 items ---------------
    mark("phase 6c")
    model = (
        lstm.Hyperparameters(N_ITEMS_FUSED, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .from_seed(3)
        .build(dev)
    )
    rng_f = np.random.default_rng(9)
    hist_f = []
    for u in range(USERS_FUSED):
        h = rng_f.integers(0, N_ITEMS_FUSED, int(rng_f.integers(3, 40))).tolist()
        if u % 5 == 0:
            h[-1] = h[0]  # held-out item already seen
        if u % 3 == 0:
            h[1] = h[0]  # a repeated seen item
        hist_f.append(h)
    test = sbr_data.Interactions.from_arrays(
        np.repeat(np.arange(USERS_FUSED), [len(h) for h in hist_f]), np.concatenate(hist_f),
        np.concatenate([np.arange(len(h)) for h in hist_f]), USERS_FUSED, N_ITEMS_FUSED,
    ).to_compressed()
    users = np.arange(USERS_FUSED)
    inputs = evaluation._batch_inputs(model, test, users, N_ITEMS_FUSED)
    table = model._params["item_table"]
    ranks = {}
    for name, (counts, self_hits, _) in (
        ("fused (K5)", evaluation._count_catalog_fused(table, *inputs, N_ITEMS_FUSED)),
        ("chunked", evaluation._count_catalog_chunked(table, *inputs, N_ITEMS_FUSED, evaluation._ITEM_CHUNK)),
    ):
        ranks[name] = (1 + counts - self_hits).cpu().numpy()
    ranks["_ranks_batched"] = evaluation._ranks_batched(model, test)
    seen_again = np.array([h[-1] in h[:-1] for h in hist_f])
    for name, r in ranks.items():
        if not (r[seen_again] == N_ITEMS_FUSED).all():
            raise SmokeFailure(f"phase 6c: {name} does not rank already-seen held-out items last")
    print(
        f"phase 6c fused vs chunked: {N_ITEMS_FUSED} items "
        f"({-(-N_ITEMS_FUSED // evaluation._ITEM_CHUNK)} chunks), {USERS_FUSED} users, "
        f"{int(seen_again.sum())} held-out items already seen", flush=True,
    )
    check_ranks("phase 6c", model, test, ranks, evaluation._ranks_generic(model, test), torch)
    del model, table, inputs, test
    torch.cuda.empty_cache()

    # -- the training path -------------------------------------------------------------
    mark("the training path")
    ml1m_model = functools.partial(fit_ml1m_model, dev)
    bench_model = functools.partial(fit_bench_model, dev)

    def check_refit(label, make, data):
        """Two fresh models from one seed, one fit each: the dense table
        step sums in a fixed order, so the tables and towers are equal bit
        for bit. Returns the second model."""
        a, b = make(), make()
        a.fit(data)
        b.fit(data)
        pa, pb = flatten(a._params), flatten(b._params)
        differ = [name for (name, x), (_, y) in zip(pa, pb) if not torch.equal(x, y)]
        if differ:
            raise SmokeFailure(f"{label}: two fits from one seed differ in {differ}")
        print(f"  {label}: two fits from one seed give equal tables and towers, bit for bit", flush=True)
        return b

    t0 = time.perf_counter()
    ml1m_data = fit_ml1m_data()
    bench_train, bench_test = fit_bench_split()
    bench_data = bench_train.to_compressed()
    print(
        f"training data: ml1m-shaped {len(ml1m_data)} interactions, bench-shaped "
        f"{len(bench_data)} training interactions, made in {time.perf_counter() - t0:.1f} s", flush=True,
    )

    # -- phase 7: one step, kernel tower against plain tower -------------------------------
    mark("phase 7")
    def ulp(t):
        """One unit in the last place of each entry of a bf16 tensor, 0 for
        an f32 one: two f32 values a rounding apart may store one ulp apart."""
        a = t.float().abs()
        if t.dtype != torch.bfloat16:
            return torch.zeros_like(a)
        return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7), a)

    def step_grad(state):
        """The gradient one step from zero state used, read back from the
        state (Adam's m = (1 - b1) g, Adagrad's acc = g^2, magnitude), and
        the slack of the state's storage rounding in the same units."""
        if "m" in state:
            return state["m"].float() / 0.1, ulp(state["m"]) / 0.1
        acc = state["acc"].float()
        return acc.sqrt(), (acc + ulp(state["acc"])).sqrt() - acc.sqrt()

    def check_update(name, got, want, s_got, s_want, g_floor=G_FLOOR, run_sum_ulps=0):
        """The gradients agree everywhere (1e-5 + 2e-4 |g|). The updated
        values agree within TOL_STEP_RTOL/ATOL wherever |g| >= g_floor; below
        it the first step's lr * g / (|g| + eps) turns the rounding noise of a
        nearly cancelled gradient into a different update, and those entries
        are only counted. A bf16 table or state may also differ by one ulp of
        its stored value. ``run_sum_ulps``: the table's gradients also differ
        by that many ulp of their column's sum_rows |g| (the run sums'
        rounding, when two devices' cumsums make them; RUN_SUM_ULPS), and
        the values are compared where |g| is at least 8 times that. Returns
        (max diff on checked entries, count excluded)."""
        slack = ulp(want)
        got, want = got.float(), want.float()
        (g_got, _), (g_want, g_slack) = step_grad(s_got), step_grad(s_want)
        if run_sum_ulps:
            col = g_want.abs().sum(dim=0)
            g_slack = g_slack + run_sum_ulps * torch.where(col > 0, torch.exp2(torch.floor(torch.log2(col)) - 23), col)
            g_floor = torch.clamp(8 * g_slack, min=g_floor)
        gbad = (g_got - g_want).abs() > 1e-5 + 2e-4 * g_want.abs() + g_slack
        if bool(gbad.any()):
            raise SmokeFailure(
                f"{name}: {int(gbad.sum())} gradient entries differ "
                f"(max diff {float((g_got - g_want).abs().max()):.3e})"
            )
        cond = g_want.abs() >= g_floor
        diff = (got - want).abs()
        bad = cond & (diff > TOL_STEP_ATOL + TOL_STEP_RTOL * want.abs() + slack)
        if bool(bad.any()):
            raise SmokeFailure(
                f"{name}: {int(bad.sum())} entries beyond rtol/atol (max diff {float(diff[bad].max()):.3e})"
            )
        return float(diff[cond].max()) if bool(cond.any()) else 0.0, int((~cond & (diff > TOL_STEP_ATOL)).sum())

    def warp_choices(params, tower, batch, cand):
        """WARP's choice per position and every candidate's margin
        ``1 - pos + cand`` under ``tower``, as the step computes them."""
        table = params["item_table"]
        b, t1 = batch["stream"].shape
        with torch.no_grad():
            rows = rowk.gather_rows(table, batch["stream"].reshape(-1)).reshape(b, t1, -1)
            hidden = tower(params["tower"], rows[:, : t1 - 1, :-1], starts=batch.get("starts"))
            haug = torch.cat([hidden, hidden.new_ones(hidden.shape[:2] + (1,))], dim=-1)
            pos = (haug * rows[:, 1:]).sum(-1)
            scores = rowk.cand_score(haug.reshape(b * (t1 - 1), -1), table, cand.reshape(b * (t1 - 1), -1))
        return warp_select(pos, scores.reshape(cand.shape)), 1.0 - pos[..., None] + scores.reshape(cand.shape)

    def result_of(params, state):
        """Copies of a step's updated tensors and their optimizer state, by
        path (the tower's leaves by their tree paths)."""
        return {
            "item_table": (params["item_table"].clone(), {k: v.clone() for k, v in state["item_table"].items()}),
            **{path: (v.clone(), {n_: s_.clone() for n_, s_ in state["tower"][path].items()})
               for path, v in flatten(params["tower"])},
        }

    def step_inputs(model, mat):
        """The first batch of ``mat``'s windows and seeded candidates."""
        hp = model.hyper
        stream, mask, starts, n, _ = model._windows(mat)
        rows = torch.arange(min(hp._batch_size, n), device=dev)
        batch = {"stream": stream[rows], "mask": mask[rows]}
        if starts is not None:
            batch["starts"] = starts[rows]
        k_cand = 5 if hp._loss == Loss.WARP else 1
        cand = torch.randint(0, hp._num_items, (len(rows), hp._max_sequence_length, k_cand),
                             generator=gen, device=dev)
        return batch, cand

    def fresh_params(model):
        return map_leaves(torch.clone, model._params)

    for label, make, mat in (("ml1m", ml1m_model, ml1m_data), ("bench", bench_model, bench_data)):
        model = make()
        hp = model.hyper
        batch, cand = step_inputs(model, mat)
        cfg = model._engine_config()
        towers_ = {
            "kernel": model._tower_fn(),
            "plain": functools.partial(lstm_apply, coupled=model._coupled()),
        }
        flips = 0
        if hp._loss == Loss.WARP:
            (ck, mk), (cp, mp) = (warp_choices(model._params, tw, batch, cand) for tw in towers_.values())
            flipped = (ck != cp) & (batch["mask"] > 0)
            near = (torch.minimum(mk.abs(), mp.abs()) <= TOL_MARGIN).any(dim=-1)
            flips = int(flipped.sum())
            print(
                f"  phase 7 {label}: WARP selections flip at {flips} of {int((batch['mask'] > 0).sum())} "
                f"supervised positions between the towers, {int((flipped & near).sum())} of them within "
                f"{TOL_MARGIN:.0e} of the margin", flush=True,
            )
            if bool((flipped & ~near).any()):
                raise SmokeFailure(f"phase 7 {label}: a WARP selection flips away from the margin")
        out = {}
        for name, tower in towers_.items():
            params = fresh_params(model)
            state = engine.init_opt_state(hp._optimizer, params)
            step = engine.make_train_step(cfg, tower)
            params, state, loss = step(params, state, batch, cand)
            result = result_of(params, state)  # the timing below steps on in place
            ms = time_ms(lambda: step(params, state, batch, cand), reps=3)
            out[name] = (result, float(loss), ms)
        (r_k, loss_k, msk), (r_p, loss_p, msp) = out["kernel"], out["plain"]
        if not abs(loss_k - loss_p) <= TOL_STEP_LOSS * abs(loss_p):
            raise SmokeFailure(f"phase 7 {label}: loss {loss_k} against plain {loss_p}")
        if flips:
            # A near-margin flip changes one negative's rows and the tower's
            # gradient: the updates are not comparable, the losses are.
            print(f"phase 7 step {label}: loss {loss_k:.6f} vs plain tower {loss_p:.6f}; updates not "
                  f"compared after {flips} near-margin WARP flips", flush=True)
            del model, out, r_k, r_p, params, state
            continue
        checked = {
            k: check_update(f"phase 7 {label} {k}", r_k[k][0], r_p[k][0], r_k[k][1], r_p[k][1]) for k in r_k
        }
        print(
            f"phase 7 step {label}: loss {loss_k:.6f} vs plain tower {loss_p:.6f}; gradients agree; "
            f"updated values max diff {max(e for e, _ in checked.values()):.3e} where |g| >= {G_FLOOR:.0e} "
            f"(rtol {TOL_STEP_RTOL:.0e}, atol {TOL_STEP_ATOL:.0e}), "
            f"{sum(c for _, c in checked.values())} entries below it beyond atol; step "
            f"{msk:.2f} ms, plain tower {msp:.2f} ms", flush=True,
        )
        del model, out, r_k, r_p, params, state
    torch.cuda.empty_cache()

    # -- phase 7b: the sparse table update against the dense one -------------------------
    mark("phase 7b")
    for label, make, mat in (
        ("bench (Adagrad, f32 table)", bench_model, bench_data),
        ("ml1m (Adam, bf16 table and state)", lambda: ml1m_model("bfloat16"), ml1m_data),
    ):
        model = make()
        hp = model.hyper
        batch, cand = step_inputs(model, mat)
        out = {}
        for sparse in (True, False):
            cfg = dataclasses.replace(model._engine_config(), sparse_updates=sparse)
            params = fresh_params(model)
            state = engine.init_opt_state(hp._optimizer, params)
            step = engine.make_train_step(cfg, model._tower_fn())
            params, state, loss = step(params, state, batch, cand)
            result = result_of(params, state)
            ms = time_ms(lambda: step(params, state, batch, cand), reps=3)
            out[sparse] = (result, float(loss), ms)
        (r_s, loss_s, ms_s), (r_d, loss_d, ms_d) = out[True], out[False]
        if not abs(loss_s - loss_d) <= TOL_STEP_LOSS * abs(loss_d):
            raise SmokeFailure(f"phase 7b {label}: loss {loss_s} against dense {loss_d}")
        checked = {
            k: check_update(f"phase 7b {label} {k}", r_s[k][0], r_d[k][0], r_s[k][1], r_d[k][1], G_FLOOR_SPARSE)
            for k in r_s
        }
        touched = int((r_s["item_table"][0] != model._params["item_table"]).any(dim=1).sum())
        print(
            f"phase 7b step {label}: sparse loss {loss_s:.6f} vs dense {loss_d:.6f}; gradients agree; "
            f"updated values max diff {max(e for e, _ in checked.values()):.3e} where |g| >= {G_FLOOR_SPARSE:.0e} "
            f"(rtol {TOL_STEP_RTOL:.0e}, atol {TOL_STEP_ATOL:.0e}, plus one ulp of a bf16 value), "
            f"{sum(c for _, c in checked.values())} entries below it beyond atol; {touched} of "
            f"{hp._num_items} rows moved; step sparse {ms_s:.2f} ms, dense {ms_d:.2f} ms", flush=True,
        )
        del model, out, r_s, r_d, params, state
    torch.cuda.empty_cache()

    # -- phase 8: fit at full width, the ml1m configuration ---------------------------------
    mark("phase 8")
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
    check_refit("phase 8 ml1m", ml1m_model, ml1m_data)
    torch.cuda.empty_cache()

    # -- phase 9: the bench.py configuration, then serving from it ----------------------------
    mark("phase 9")
    model = bench_model()
    first = model.fit(bench_data)
    h0 = model.history
    if not (np.isfinite(first) and h0.epoch_losses[-1] < h0.epoch_losses[0]):
        raise SmokeFailure(f"phase 9: epoch losses {h0.epoch_losses.tolist()} do not fall")
    zero_counters()
    again = model.fit(bench_data)
    read_counters("bench fit", warp_kernels)
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
    check_refit("phase 9 bench", bench_model, bench_data)
    ptr, items = bench_data.user_pointers, bench_data.item_ids
    hist_t = [items[ptr[u] : ptr[u + 1]].tolist() for u in range(len(ptr) - 1) if ptr[u + 1] > ptr[u]][:64]
    check_lists("phase 9 recommend_batch", model.recommend_batch(hist_t, k=K), hist_t, BENCH_ITEMS)
    held_out = bench_test.to_compressed()
    zero_counters()
    t0 = time.perf_counter()
    metrics = {
        "MRR": evaluation.mrr_score(model, held_out),
        f"hit rate@{K}": evaluation.hit_rate_score(model, held_out, k=K),
        f"NDCG@{K}": evaluation.ndcg_score(model, held_out, k=K),
    }
    t_eval = time.perf_counter() - t0
    read_counters("bench evaluation", ("lstm_fwd",))
    untrained = evaluation.mrr_score(bench_model(), held_out)
    print(
        f"phase 9 eval on the {int((np.diff(held_out.user_pointers) >= 2).sum())} held-out users "
        f"(single chunk, chunked counter): "
        + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
        + f" in {t_eval * 1e3:.1f} ms for the three; untrained model MRR {untrained:.6f}",
        flush=True,
    )
    if not all(np.isfinite(v) for v in metrics.values()) or not metrics["MRR"] > untrained:
        raise SmokeFailure(f"phase 9: metrics {metrics}, untrained MRR {untrained}")

    del model, held_out, bench_data, ml1m_data
    torch.cuda.empty_cache()

    # -- phases 10 and 11: sparse training at 10M (f32) and 20M (bf16) items ---------------
    mark("phases 10 and 11")
    def items_model(num_items, dtype):
        return items_hyper(num_items, dtype).build(dev)

    for phase, num_items, dtype in (("10", N_ITEMS, "float32"), ("11", N_ITEMS_BF16, "bfloat16")):
        label = f"fit-{num_items // 1_000_000}M-{'sparse' if dtype == 'float32' else 'bf16'}"
        t0 = time.perf_counter()
        mat = datasets.synthetic_interactions(FIT_USERS, num_items, FIT_ITEMS_PER_USER, rng=0).to_compressed()
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = items_model(num_items, dtype)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if not model._engine_config().sparse_updates:
            raise SmokeFailure(f"phase {phase}: the sparse update is not on")
        torch.cuda.reset_peak_memory_stats()
        warm = model.fit(mat)
        wall_warm = model.history.wall_s
        zero_counters()
        loss = model.fit(mat)
        h = model.history
        read_counters(label, sparse_kernels)
        if not (np.isfinite(warm) and np.isfinite(loss)):
            raise SmokeFailure(f"phase {phase}: losses {warm}, {loss}")
        steps = h.num_epochs * -(-model._windows(mat)[3] // model.hyper._batch_size)
        print(
            f"phase {phase} {label} ({num_items} items, {dtype} table and Adagrad state, LSTM-{DIM} "
            f"{model.hyper._lstm_variant.value}, T={FIT_T}, WARP, packed, batch 256, sparse updates): "
            f"{h.examples_per_sec:.1f} examples/s ({h.examples_per_epoch} examples, {steps} steps, "
            f"{h.wall_s:.3f} s; warm-up fit {wall_warm:.3f} s), loss {loss:.6f} (warm-up {warm:.6f}); "
            f"data made in {t_data:.1f} s, model built in {t_build:.1f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True,
        )
        if phase == "10":
            profiled(f"phase 10 profile, one {label} fit", lambda: model.fit(mat), top=14)
            # The trained 10M-item model through the evaluation path.
            test = datasets.synthetic_interactions(EVAL_USERS[0], num_items, 20, rng=1).to_compressed()
            evaluation.mrr_score(model, test)  # warm-up
            zero_counters()
            t0 = time.perf_counter()
            mrr = evaluation.mrr_score(model, test)
            t_eval = time.perf_counter() - t0
            read_counters(f"{label} evaluation", eval_kernels)
            print(f"phase 10 eval of the trained model, U={EVAL_USERS[0]}: MRR {mrr:.6f} in "
                  f"{t_eval * 1e3:.1f} ms", flush=True)
            if not (np.isfinite(mrr) and 0 < mrr <= 1):
                raise SmokeFailure(f"phase 10: MRR {mrr}")
            # K5's near-tie difference where it matters to users: the MRR of the
            # same users through the fused 3xTF32 counter and the plain FP32
            # chunked counter.
            users = np.flatnonzero(np.diff(test.user_pointers) >= 2)
            inputs = evaluation._batch_inputs(model, test, users, num_items)
            mrrs = {}
            for name, (counts, self_hits, _) in (
                ("fused (K5)", evaluation._count_catalog_fused(model._params["item_table"], *inputs, num_items)),
                ("chunked (FP32)", evaluation._count_catalog_chunked(
                    model._params["item_table"], *inputs, num_items, evaluation._ITEM_CHUNK)),
            ):
                ranks = (1 + counts - self_hits).double()
                mrrs[name] = (ranks, float((1.0 / ranks).mean()))
            (r_f, m_f), (r_c, m_c) = mrrs.values()
            print(f"phase 10 K5 near-ties on the trained model, {len(users)} users: MRR fused {m_f:.9f}, chunked "
                  f"{m_c:.9f}, difference {m_f - m_c:+.3e}; ranks differ for {int((r_f != r_c).sum())} users, by at "
                  f"most {int((r_f - r_c).abs().max())}", flush=True)
            del inputs
            ptr = test.user_pointers
            sub = sbr_data.CompressedInteractions(
                EVAL_REF_USERS, num_items, ptr[: EVAL_REF_USERS + 1], test.item_ids[: ptr[EVAL_REF_USERS]],
                test.timestamps[: ptr[EVAL_REF_USERS]],
            )
            check_ranks("phase 10", model, sub, {"batched (K5)": evaluation._ranks_batched(model, sub)},
                        evaluation._ranks_generic(model, sub), torch)
            del test, sub
        del model, mat
        torch.cuda.empty_cache()

    # -- phases 12-14: the EWMA, GRU and attention families ----------------------------------
    mark("phases 12-14")
    # Each family's tower is plain PyTorch (no Pallas kernel stands behind it
    # in the JAX package); its paths still run the ported kernels: P1 and P2
    # in every dense step, P3 in the WARP steps, K4 when serving, K5 in the
    # evaluation, and never K1 or K2.
    crit_data = criterion_sample()
    warp_data = bench_train.to_compressed()
    held_out = bench_test.to_compressed()
    ptr, items = warp_data.user_pointers, warp_data.item_ids
    hist_t = [items[ptr[u] : ptr[u + 1]].tolist() for u in range(len(ptr) - 1) if ptr[u + 1] > ptr[u]][:64]
    fit_kernels = ("gather_rows", "scatter_add_rows")

    def profiled_steps(label, model, mat, steps):
        """A window of ``model``'s fit on ``mat`` under ``torch.profiler``:
        ``steps`` steps on its first batches with fresh candidates, after one
        warm-up step (the host traces a launch in about 0.5 ms, and a whole
        eager fit launches 45,000 to 500,000 kernels). Prints per step the
        wall, the device's busy time and the launches, the idle share and
        the top kernels."""
        hp = model.hyper
        stream, mask, starts, n, _ = model._windows(mat)
        size = min(hp._batch_size, n)
        k_cand = 5 if hp._loss == Loss.WARP else 1
        step = engine.make_train_step(model._engine_config(), model._tower_fn(), total_steps=steps + 1,
                                      generator=model._dropout_generator)
        state = engine.init_opt_state(hp._optimizer, model._params)
        batches = []
        for i in range(steps + 1):
            rows = torch.arange(i * size, (i + 1) * size, device=dev) % n
            batch = {"stream": stream[rows], "mask": mask[rows]}
            if starts is not None:
                batch["starts"] = starts[rows]
            cand = torch.randint(0, hp._num_items, (size, hp._max_sequence_length, k_cand), generator=gen,
                                 device=dev)
            batches.append((batch, cand))

        def run(window):
            for batch, cand in window:
                step(model._params, state, batch, cand)
            torch.cuda.synchronize()

        run(batches[:1])
        wall_ms, busy_ms, n_launch = profiled(f"{label} ({steps} steps)", lambda: run(batches[1:]), top=8)
        print(f"  a step: wall {wall_ms / steps:.2f} ms, device busy {busy_ms / steps:.3f} ms, "
              f"{n_launch / steps:.0f} device launches", flush=True)

    for phase, family in zip(("12", "13", "14"), FAMILIES):
        t_phase = time.perf_counter()
        mark(f"phase {phase} {family} steps, card against CPU")

        # One training step on the card against the same step on the CPU:
        # the same numpy parameters, batch and candidates.
        for label, make, mat in (
            ("criterion", functools.partial(criterion_model, family), crit_data),
            ("tuned WARP", functools.partial(tuned_warp_model, family), warp_data),
        ):
            model, cpu_model = make(dev), make("cpu")
            cpu_model.load_numpy_params(params_to_numpy(model))
            hp = model.hyper
            batch, cand = step_inputs(model, mat)
            runs = {"card": (model, batch, cand), "cpu": (cpu_model, {k: v.cpu() for k, v in batch.items()}, cand.cpu())}
            flips = 0
            if hp._loss == Loss.WARP:
                (ck, mk), (cp, mp) = [
                    [x.to(dev) for x in warp_choices(m._params, m._tower_fn(), b, c)] for m, b, c in runs.values()
                ]
                flipped = (ck != cp) & (batch["mask"] > 0)
                near = (torch.minimum(mk.abs(), mp.abs()) <= TOL_MARGIN).any(dim=-1)
                flips = int(flipped.sum())
                if bool((flipped & ~near).any()):
                    raise SmokeFailure(f"phase {phase} {family} {label}: a WARP selection flips away from the margin")
            out = {}
            for where, (m, b, c) in runs.items():
                params = fresh_params(m)
                state = engine.init_opt_state(hp._optimizer, params)
                step = engine.make_train_step(m._engine_config(), m._tower_fn())
                params, state, loss = step(params, state, b, c)
                out[where] = (map_leaves(lambda v: v.to(dev), result_of(params, state)), float(loss))
                if where == "card":
                    out["ms"] = time_ms(lambda: step(params, state, b, c), reps=3)
            (r_k, loss_k), (r_p, loss_p) = out["card"], out["cpu"]
            if not abs(loss_k - loss_p) <= TOL_STEP_LOSS * abs(loss_p):
                raise SmokeFailure(f"phase {phase} {family} {label}: card loss {loss_k} against CPU {loss_p}")
            if flips:
                print(f"phase {phase} {family} step ({label}): card loss {loss_k:.6f} vs CPU {loss_p:.6f}; updates "
                      f"not compared after {flips} near-margin WARP flips; card step {out['ms']:.2f} ms", flush=True)
            else:
                checked = {
                    k: check_update(f"phase {phase} {family} {label} {k}", r_k[k][0], r_p[k][0], r_k[k][1], r_p[k][1],
                                    run_sum_ulps=RUN_SUM_ULPS if k == "item_table" else 0)
                    for k in r_k
                }
                print(
                    f"phase {phase} {family} step ({label}, {hp._loss.value}/{hp._optimizer.value}): card loss "
                    f"{loss_k:.6f} vs CPU {loss_p:.6f}; gradients agree; updated values max diff "
                    f"{max(e for e, _ in checked.values()):.3e} where |g| >= {G_FLOOR:.0e} (the table: and >= 8x "
                    f"its {RUN_SUM_ULPS} run-sum ulps), "
                    f"{sum(c for _, c in checked.values())} entries below it beyond atol; WARP flips {flips}; "
                    f"card step {out['ms']:.2f} ms", flush=True,
                )
            del model, cpu_model, out, r_k, r_p, params, state

        # The criterion fit cell: two fresh fits from one seed, bit for bit;
        # the second model's fit is the warm-up of the timed fits and the
        # profiled fit that follow on it.
        mark(f"phase {phase} {family} criterion fit")
        model = check_refit(f"phase {phase} {family} criterion", functools.partial(criterion_model, family, dev),
                            crit_data)
        repeats = CRITERION_REPEATS_GRU if family == "gru" else CRITERION_REPEATS
        zero_counters()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            model.fit(crit_data)
            times.append(time.perf_counter() - t0)
        read_counters(f"{family} criterion fit", fit_kernels, absent=lstm_kernels)
        h = model.history
        steps = h.num_epochs * -(-model._windows(crit_data)[3] // model.hyper._batch_size)
        mean = statistics.mean(times)
        print(
            f"phase {phase} {family} criterion fit (dim 32, T=128, Hinge/Adagrad, batch 32, 3 epochs, "
            f"{CRITERION_SAMPLE} interactions): {len(times)} fits mean {mean * 1e3:.1f} ms, min "
            f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}; {h.examples_per_epoch * h.num_epochs / mean:.1f} "
            f"examples/s at the mean ({steps} steps a fit)", flush=True,
        )
        profiled_steps(f"phase {phase} profile, {family} criterion fit", model, crit_data, PROFILE_STEPS[family])
        del model

        # The tuned WARP configuration (epochs cut to WARP_EPOCHS); attention
        # also with dropout 0.2, which draws from its dropout generator.
        mark(f"phase {phase} {family} tuned WARP fit")
        variants = [("", 0.0)] + ([(", dropout 0.2", 0.2)] if family == "attention" else [])
        for suffix, rate in variants:
            model = tuned_warp_model(family, dev, dropout=rate)
            untrained = evaluation.mrr_score(model, held_out)
            dropout_state = model._dropout_generator.get_state()
            zero_counters()
            t0 = time.perf_counter()
            loss = model.fit(warp_data)
            t_fit = time.perf_counter() - t0
            read_counters(f"{family} tuned WARP fit{suffix}", fit_kernels + ("cand_score_smem",), absent=lstm_kernels)
            h = model.history
            drew = not torch.equal(dropout_state, model._dropout_generator.get_state())
            if not (np.isfinite(loss) and h.epoch_losses[-1] < h.epoch_losses[0]) or drew != (rate > 0):
                raise SmokeFailure(f"phase {phase} {family}{suffix}: epoch losses {h.epoch_losses.tolist()}, "
                                   f"dropout stream moved: {drew}")
            ids_a, vals_a = model.recommend_batch(hist_t, k=K, return_scores=True)
            ids_b, vals_b = model.recommend_batch(hist_t, k=K, return_scores=True)
            if ids_a != ids_b or not np.array_equal(vals_a, vals_b):
                raise SmokeFailure(f"phase {phase} {family}{suffix}: serving is not deterministic")
            check_lists(f"phase {phase} {family}{suffix} recommend_batch", ids_a, hist_t, BENCH_ITEMS)
            metrics = {
                "MRR": evaluation.mrr_score(model, held_out),
                f"hit rate@{K}": evaluation.hit_rate_score(model, held_out, k=K),
                f"NDCG@{K}": evaluation.ndcg_score(model, held_out, k=K),
            }
            print(
                f"phase {phase} {family} tuned WARP fit{suffix} ({model.hyper._optimizer.value}, "
                f"{h.num_epochs} epochs, batch {model.hyper._batch_size}, T={model.hyper._max_sequence_length}): "
                f"{h.examples_per_epoch * h.num_epochs / t_fit:.1f} examples/s ({t_fit:.3f} s); epoch losses "
                f"{h.epoch_losses[0]:.1f} -> {h.epoch_losses[-1]:.1f}; held-out "
                + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
                + f"; untrained MRR {untrained:.6f}", flush=True,
            )
            if not all(np.isfinite(v) for v in metrics.values()) or not metrics["MRR"] > untrained:
                raise SmokeFailure(f"phase {phase} {family}{suffix}: metrics {metrics}, untrained MRR {untrained}")
            if not suffix:
                profiled_steps(f"phase {phase} profile, {family} tuned WARP fit", model, warp_data,
                               PROFILE_STEPS[family])
            del model
        torch.cuda.empty_cache()

        # Serving and evaluation at serve-10M's shape.
        mark(f"phase {phase} {family} serving and evaluation at {N_ITEMS} items")
        t0 = time.perf_counter()
        model = family_serving_model(family, N_ITEMS, dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        histories = serving_histories(N_ITEMS)
        zero_counters()
        model.recommend_batch(histories, k=K)  # warm-up
        before = topk_streamed.rechecked_users
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ids, vals = model.recommend_batch(histories, k=K, return_scores=True)
            times.append(time.perf_counter() - t0)
        read_counters(f"{family} serving path", ("score_submax_groupmax",), absent=lstm_kernels)
        t_med = statistics.median(times)
        print(
            f"phase {phase} {family} serve-10M (dim {DIM}, T={SEQ_LEN}, {N_ITEMS} items, built in {t_build:.1f} s) "
            f"recommend_batch k={K}: {USERS / t_med:.1f} users/s (median of 3: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per batch of {USERS}); the certificate sent "
            f"{(topk_streamed.rechecked_users - before) / 3:g} of {USERS} users a batch to the FP32 K4", flush=True,
        )
        profiled(f"phase {phase} profile, one {family} batch at {N_ITEMS} items",
                 lambda: model.recommend_batch(histories, k=K), top=6)
        check_lists(f"phase {phase} {family}", ids, histories, N_ITEMS)
        check_against_reference(f"phase {phase} {family}", model, histories[:REF_USERS], ids[:REF_USERS],
                                vals[:REF_USERS], model._tower_fn(), torch)
        mark(f"phase {phase} {family} eval-10M-{EVAL_USERS[0]}")
        test = eval_test(EVAL_USERS[0])
        evaluation.mrr_score(model, test)  # warm-up
        zero_counters()
        times, mrrs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            mrrs.append(evaluation.mrr_score(model, test))
            times.append(time.perf_counter() - t0)
        read_counters(f"{family} evaluation path", ("score_count_ge",), absent=lstm_kernels)
        t_med = statistics.median(times)
        print(
            f"phase {phase} {family} eval-10M-{EVAL_USERS[0]}: {t_med * 1e6 / EVAL_USERS[0]:.1f} us per user "
            f"(median of 3: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms), MRR {mrrs[0]:.6f}", flush=True,
        )
        if tk.score_count_ge.launches != 3 or not all(np.isfinite(m) and 0 < m <= 1 for m in mrrs):
            raise SmokeFailure(f"phase {phase} {family}: {tk.score_count_ge.launches} K5 launches, MRR {mrrs}")
        profiled(f"phase {phase} profile, one {family} eval at {N_ITEMS} items, U={EVAL_USERS[0]}",
                 lambda: evaluation.mrr_score(model, test), top=6)
        mark(f"phase {phase} {family} ranks against the per-user loop")
        ptr = test.user_pointers
        sub = sbr_data.CompressedInteractions(
            EVAL_REF_USERS, N_ITEMS, ptr[: EVAL_REF_USERS + 1], test.item_ids[: ptr[EVAL_REF_USERS]],
            test.timestamps[: ptr[EVAL_REF_USERS]],
        )
        check_ranks(f"phase {phase} {family}", model, sub, {"batched (K5)": evaluation._ranks_batched(model, sub)},
                    evaluation._ranks_generic(model, sub), torch)
        del model, test, sub, ids, vals
        torch.cuda.empty_cache()
        print(f"phase {phase} {family}: {time.perf_counter() - t_phase:.1f} s in all", flush=True)

    checkpoint_phases(dev, mark, zero_counters, read_counters, warp_kernels, eval_kernels)
    mesh_phases(dev, mark, launches, launches_by_path, served)

    kernels = []
    sources = {
        "lstm_fwd": ("sbr_rs_tpu_torch/csrc/lstm_fwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:49"),
        "lstm_bwd": ("sbr_rs_tpu_torch/csrc/lstm_bwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:82"),
        "lstm_bwd_dwh": ("sbr_rs_tpu_torch/csrc/lstm_bwd.cu", "sbr_rs_tpu/ops/pallas_lstm.py:82"),
        "score_groupmax": ("sbr_rs_tpu_torch/csrc/score_submax_tc.cu", "sbr_rs_tpu/ops/pallas_topk.py:108"),
        "score_groupmax_fp32": ("sbr_rs_tpu_torch/csrc/score_groupmax.cu", "sbr_rs_tpu/ops/pallas_topk.py:108"),
        "score_submax_groupmax": ("sbr_rs_tpu_torch/csrc/score_submax_tc.cu", "sbr_rs_tpu/ops/pallas_topk.py:130"),
        "score_submax_groupmax_fp32": ("sbr_rs_tpu_torch/csrc/score_groupmax.cu", "sbr_rs_tpu/ops/pallas_topk.py:130"),
        "score_count_ge": ("sbr_rs_tpu_torch/csrc/score_count.cu", "sbr_rs_tpu/ops/pallas_topk.py:365"),
        "gather_rows": ("sbr_rs_tpu_torch/csrc/row_gather.cu", "scripts/row_pipeline_probe.py:48"),
        "scatter_add_rows": ("sbr_rs_tpu_torch/csrc/row_gather.cu", "scripts/row_pipeline_probe.py:70"),
        "cand_score_smem": ("sbr_rs_tpu_torch/csrc/cand_score.cu", "scripts/cand_gather_probe.py:112"),
        "cand_score_rows": ("sbr_rs_tpu_torch/csrc/cand_score.cu", "scripts/cand_gather_probe.py:156"),
    }
    for name, (source, replaces) in sources.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], **r, "launches_by_path": launches_by_path[name],
        })
    print(json.dumps({"kernels": kernels}))
    print_contract_line()


def print_contract_line():
    """The last line of a run whose phases all passed."""
    import torch

    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


def host_rss_kb():
    """This process's resident set (``VmRSS``), in kB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise SmokeFailure("/proc/self/status has no VmRSS")


def peak_host_memory(fn):
    """``(fn(), seconds, GB of host RSS above the level before at the call's
    peak)``, the peak sampled every 2 ms by a thread: neither ``ru_maxrss``
    (the peak of the earlier phases) nor a ``VmHWM`` reset (``/proc/self/
    clear_refs`` is not writable in every container) gives one call's peak."""
    import threading

    import torch

    stop = threading.Event()
    before = host_rss_kb()
    peak = [before]

    def sample():
        while not stop.wait(0.002):
            peak[0] = max(peak[0], host_rss_kb())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        sampler.join()
    return out, seconds, (max(peak[0], host_rss_kb()) - before) * 1024 / 1e9


def checkpoint_phases(dev, mark, zero_counters, read_counters, warp_kernels, eval_kernels):
    """Phases 15a-17: a trained fit-bench model saved and loaded (on the
    card and on the CPU), serve-10M's model through a 5.12 GB checkpoint, a
    bf16 table past flax's chunk size and the families' trees, the profiler
    trace of a serve-10M batch (in a process of its own), and the
    quickstart example."""
    import importlib.util

    import torch
    from sbr_rs_tpu_torch import evaluation
    from sbr_rs_tpu_torch.models import lstm
    from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
    from sbr_rs_tpu_torch.utils import checkpoint, msgpack_codec
    from sbr_rs_tpu_torch.utils.tree import flatten

    tmp = tempfile.mkdtemp(prefix="sbr_ckpt_")
    try:
        # -- phase 15a: fit-bench saved on the card, loaded on the card and the CPU --
        mark("phase 15a")
        bench_train, bench_test = fit_bench_split()
        data, held_out = bench_train.to_compressed(), bench_test.to_compressed()
        model = fit_bench_model(dev)
        model.fit(data)
        ptr, items = data.user_pointers, data.item_ids
        hist = [items[ptr[u] : ptr[u + 1]].tolist() for u in range(len(ptr) - 1) if ptr[u + 1] > ptr[u]][:64]
        path = os.path.join(tmp, "fit-bench")
        t0 = time.perf_counter()
        model.save(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        copy = ImplicitSequenceModel.load(path)
        t_load = time.perf_counter() - t0
        if copy.device.type != dev.type:
            raise SmokeFailure(f"phase 15a: the loaded model is on {copy.device}, not the card")
        served = [m.recommend_batch(hist, k=K, return_scores=True) for m in (model, copy)]
        if served[0][0] != served[1][0] or not np.array_equal(served[0][1], served[1][1]):
            raise SmokeFailure("phase 15a: the loaded model serves other ids or scores")
        metrics = [
            (evaluation.mrr_score(m, held_out), evaluation.hit_rate_score(m, held_out, k=K),
             evaluation.ndcg_score(m, held_out, k=K))
            for m in (model, copy)
        ]
        if metrics[0] != metrics[1]:
            raise SmokeFailure(f"phase 15a: metrics {metrics[0]} before the save, {metrics[1]} after")
        cpu = ImplicitSequenceModel.load(path, "cpu")
        reps_card, reps_cpu = (np.stack([u.user_embedding for u in m.user_representations(hist)]) for m in (copy, cpu))
        rep_err = float(np.abs(reps_card - reps_cpu).max())
        if not rep_err <= TOL_LSTM or cpu.device.type != "cpu":
            raise SmokeFailure(f"phase 15a: CPU representations {rep_err:.3e} from the card's")
        zero_counters()
        loss_copy = copy.fit(data)
        read_counters("fit-bench fit continued from its checkpoint", warp_kernels)
        loss_model = model.fit(data)
        leaves = [("item_table", model._params["item_table"], copy._params["item_table"])] + [
            (name, v, w) for (name, v), (_, w) in zip(flatten(model._params["tower"]), flatten(copy._params["tower"]))
        ]
        differ = [name for name, v, w in leaves if not torch.equal(v, w)]
        if differ or loss_copy != loss_model:
            raise SmokeFailure(f"phase 15a: the continued fits differ (losses {loss_model}, {loss_copy}; {differ})")
        print(
            f"phase 15a fit-bench checkpoint: saved in {t_save * 1e3:.1f} ms, loaded on the card in "
            f"{t_load * 1e3:.1f} ms; {len(hist)} users served bit-equal; MRR {metrics[0][0]:.6f}, hit rate@{K} "
            f"{metrics[0][1]:.6f}, NDCG@{K} {metrics[0][2]:.6f} equal; one more fit from each: loss "
            f"{loss_model:.6f}, parameters bit-equal (generators restored); loaded on the CPU: representations "
            f"within {rep_err:.3e} of the card's (tol {TOL_LSTM:.0e})", flush=True,
        )
        del model, copy, cpu

        # -- phase 15b: ckpt-10M, serve-10M's model through a 5.12 GB checkpoint ------
        mark("phase 15b")
        free = shutil.disk_usage(tmp).free
        row_bytes = (DIM + 1) * 4
        num_items = N_ITEMS
        if free < N_ITEMS * row_bytes * 1.02:
            num_items = min(int(free * 0.9) // row_bytes, N_ITEMS)
        print(f"phase 15b free disk at {tmp}: {free / 1e9:.2f} GB; catalog {num_items} items "
              f"({num_items * row_bytes / 1e9:.2f} GB)" + (" (cut: the disk is short)" if num_items < N_ITEMS else ""),
              flush=True)
        chunks = -(-num_items * row_bytes // msgpack_codec.MAX_CHUNK_SIZE)
        if chunks < CKPT_MIN_CHUNKS:
            raise SmokeFailure(f"phase 15b: the disk holds {free / 1e9:.2f} GB, less than {CKPT_MIN_CHUNKS} chunks")
        model = serving_model(num_items, dev)
        histories = serving_histories(num_items)
        test = eval_test(EVAL_USERS[0], num_items)
        ids0, vals0 = model.recommend_batch(histories, k=K, return_scores=True)
        mrr0 = evaluation.mrr_score(model, test)
        path = os.path.join(tmp, "serve-10M")
        saved = {}
        _, t_save, rss_save = peak_host_memory(lambda: checkpoint.save_model(model, path, saved))
        size = os.path.getsize(os.path.join(path, checkpoint.STATE))
        if b"__msgpack_chunked_array__" not in open(os.path.join(path, checkpoint.STATE), "rb").read(4096):
            raise SmokeFailure("phase 15b: the table was not written in flax's chunks")
        loaded = {}
        copy, t_load, rss_load = peak_host_memory(lambda: checkpoint.load_model(path, dev, loaded))
        print(
            f"phase 15b ckpt-10M ({num_items} x {DIM + 1} f32 table, {chunks} chunks): state.msgpack {size} bytes; "
            f"save {t_save:.3f} s ({size / t_save / 1e9:.3f} GB/s; busy: device->host {saved['d2h_s']:.3f} s, "
            f"hash {saved['hash_s']:.3f} s, write {saved['write_s']:.3f} s, overlapped), peak host RSS "
            f"+{rss_save:.3f} GB; load {t_load:.3f} s ({size / t_load / 1e9:.3f} GB/s; busy: read "
            f"{loaded['read_s']:.3f} s, hash {loaded['hash_s']:.3f} s; the model build included), peak host RSS "
            f"+{rss_load:.3f} GB", flush=True,
        )
        if not torch.equal(copy._params["item_table"], model._params["item_table"]):
            raise SmokeFailure("phase 15b: the loaded table differs")
        del model
        torch.cuda.empty_cache()
        zero_counters()
        ids1, vals1 = copy.recommend_batch(histories, k=K, return_scores=True)
        read_counters("ckpt-10M serving from the loaded model", ("lstm_fwd", "score_submax_groupmax"))
        if ids1 != ids0 or not np.array_equal(vals1, vals0):
            raise SmokeFailure("phase 15b: the loaded model serves other ids or scores")
        zero_counters()
        mrr1 = evaluation.mrr_score(copy, test)
        read_counters("ckpt-10M evaluation of the loaded model", eval_kernels)
        if mrr1 != mrr0:
            raise SmokeFailure(f"phase 15b: MRR {mrr0} before the save, {mrr1} after")
        print(f"phase 15b {len(histories)} users served bit-equal from the loaded model; MRR of "
              f"eval-10M-{EVAL_USERS[0]}'s users {mrr1:.9e}, equal", flush=True)
        shutil.rmtree(path)
        del copy
        torch.cuda.empty_cache()

        # -- phase 15c: a bf16 table past the chunk size; the families' trees ---------
        mark("phase 15c")
        bf16 = (lstm.Hyperparameters(N_ITEMS_CKPT_BF16, SEQ_LEN).embedding_dim(DIM).table_dtype("bfloat16")
                .from_seed(1).build(dev))
        path = os.path.join(tmp, "bf16")
        _, t_save, _ = peak_host_memory(lambda: bf16.save(path))
        back, t_load, _ = peak_host_memory(lambda: ImplicitSequenceModel.load(path))
        table, table_back = bf16._params["item_table"], back._params["item_table"]
        if table_back.dtype != torch.bfloat16 or not torch.equal(table.view(torch.int16), table_back.view(torch.int16)):
            raise SmokeFailure("phase 15c: the bf16 table did not round-trip bit for bit")
        print(f"phase 15c bf16 table {N_ITEMS_CKPT_BF16} x {DIM + 1} ({table.numel() * 2 / 1e9:.2f} GB, "
              f"{-(-table.numel() * 2 // msgpack_codec.MAX_CHUNK_SIZE)} chunks): saved in {t_save:.3f} s, loaded in {t_load:.3f} s, "
              f"bit for bit", flush=True)
        del bf16, back, table, table_back
        shutil.rmtree(path)
        for family in FAMILIES:
            model = criterion_model(family, dev)
            path = os.path.join(tmp, family)
            model.save(path)
            back = ImplicitSequenceModel.load(path)
            reps = [np.stack([u.user_embedding for u in m.user_representations(hist)]) for m in (model, back)]
            if type(back) is not type(model) or not np.array_equal(*reps):
                raise SmokeFailure(f"phase 15c: {family}'s representations differ after the round trip")
            print(f"phase 15c {family} criterion model ({len(flatten(model._params['tower']))} tower leaves): "
                  f"representations of {len(hist)} users bit-equal after the round trip", flush=True)
        print(f"phase 15c msgpack importable on this machine: {importlib.util.find_spec('msgpack') is not None} "
              "(for information: the port reads and writes without it)", flush=True)

        # -- phase 16: the profiler trace of one serve-10M batch -----------------------
        # In its own process: late in a process that has kept the card busy,
        # torch's profiler drops a region's first kernel records
        # (utils.metrics.trace, PERF.md §7; scripts/torch_trace_probe.py).
        mark("phase 16")
        log_dir = os.path.join(tmp, "trace")
        root = os.path.dirname(os.path.abspath(__file__))
        code = f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; chip_smoke.trace_serve_batch({log_dir!r})"
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SmokeFailure(f"phase 16: the traced process failed: {proc.stderr[-2000:]}")
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise SmokeFailure(f"phase 16: {len(files)} trace files in {log_dir}")
        events = json.load(open(files[0]))["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        missing = [name for name in TRACE_SYMBOLS if not any(name in e["name"] for e in kernels)]
        print(f"phase 16 trace of one serve-10M batch (a process of its own): {os.path.getsize(files[0])} bytes, "
              f"{len(events)} events, {len(kernels)} kernels"
              + (f"; missing {missing}" if missing else f", naming {', '.join(TRACE_SYMBOLS)}"), flush=True)
        if missing:
            raise SmokeFailure(f"phase 16: the trace does not name {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- phase 17: the quickstart example on the card ---------------------------------
    mark("phase 17")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "torch_quickstart.py"), "--epochs", "1"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.strip().splitlines()
    print(f"phase 17 examples/torch_quickstart.py --epochs 1: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in lines:
        print(f"  {line}", flush=True)
    if proc.returncode != 0 or not any("the copy serves the same top-10" in line for line in lines):
        raise SmokeFailure(f"phase 17: the quickstart failed: {proc.stderr[-2000:]}")


def mesh_phases(dev, mark, launches, launches_by_path, served):
    """Phases 18a and 18b: the mesh on the card. 18a: world size 1 through
    ``parallel.initialize`` (NCCL, a one-rank TCP rendezvous), a (1, 1) mesh
    fit-bench fit bit-equal to the mesh-less one. 18b: four ranks on the one
    card over gloo (NCCL refuses two ranks on one device), a (2, 2) mesh:
    fit-10M-sparse-mesh, and the same with Hinge, each bit-equal to the
    world-size-1 fit that runs each batch as two shares on the same draws
    (the plain world-size-1 fit holds WARP's loss to 1e-4 and prints its
    distance), the ranks' sharded save loaded at world size 1 bit-equal to
    the fit, eval-10M-512-mesh (K5 on each slab) against the world-size-1
    ranks of the loaded model; two ranks: a
    (1, 2) fit bit-equal to the world-size-1 fit, and ckpt-10M-sharded
    loaded, each slab bit-equal to the world-size-1 load. With two cards or
    more, the fit again over NCCL, one rank a card."""
    import torch
    from sbr_rs_tpu_torch import datasets, evaluation, parallel
    from sbr_rs_tpu_torch.models import Loss, engine
    from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
    from sbr_rs_tpu_torch.utils.tree import flatten
    from scripts.torch_multiprocess_fit import free_port, launch

    # -- phase 18a: world size 1 over NCCL ---------------------------------------------
    mark("phase 18a")
    t0 = time.perf_counter()
    data = fit_bench_split()[0].to_compressed()
    parallel.initialize(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, backend="nccl")
    try:
        plain, meshed = fit_bench_model(dev), fit_bench_model(dev, parallel.make_mesh(1, 1))
        plain.fit(data)
        meshed.fit(data)
    finally:
        parallel.shutdown()
    differ = [path for (path, a), (_, b) in zip(flatten(plain._params), flatten(meshed._params)) if not torch.equal(a, b)]
    if differ or not np.array_equal(plain.history.epoch_losses, meshed.history.epoch_losses):
        raise SmokeFailure(f"phase 18a: the (1, 1) mesh fit differs from the mesh-less fit ({differ})")
    print(f"phase 18a fit-bench on a (1, 1) mesh (NCCL, world size 1): epoch losses and every parameter "
          f"bit-equal to the mesh-less fit ({plain.history.epoch_losses[0]:.3f} -> "
          f"{plain.history.epoch_losses[-1]:.3f}); {time.perf_counter() - t0:.1f} s", flush=True)
    del plain, meshed

    # -- phase 18b: (2, 2) over gloo, four ranks on the card ------------------------------
    mark("phase 18b")
    t_phase = time.perf_counter()
    hyper = items_hyper(N_ITEMS, "float32")
    hinge = items_hyper(N_ITEMS, "float32").loss(Loss.HINGE)
    mat = datasets.synthetic_interactions(FIT_USERS, N_ITEMS, FIT_ITEMS_PER_USER, rng=0).to_compressed()
    test = eval_test(EVAL_USERS[0], N_ITEMS)
    tmp = tempfile.mkdtemp(prefix="sbr_mesh_")
    try:
        name = "fit-10M-sparse-mesh"
        fit_case = {"family": "lstm", "mesh": list(MESH_SHAPE), "data": [FIT_USERS, N_ITEMS, FIT_ITEMS_PER_USER, 0],
                    "fit": True, "sha256": True}
        spec = {
            "backend": "gloo", "device": "cuda", "timeout_s": MESH_COLLECTIVE_TIMEOUT_S, "inputs": None,
            "out": os.path.join(tmp, "out4.npz"),
            "cases": [{**fit_case, "name": name, "hyper": hyper.to_dict(),
                       "eval": [EVAL_USERS[0], N_ITEMS, 20, EVAL_SEEDS[EVAL_USERS[0]]],
                       "save": os.path.join(tmp, "ws4")},
                      {**fit_case, "name": f"{name}-hinge", "hyper": hinge.to_dict()}] + serve_mesh_cases(served),
        }
        t0 = time.perf_counter()
        run = launch(MESH_SHAPE[0] * MESH_SHAPE[1], spec, os.path.join(tmp, "spec4.json"), MESH_TIMEOUT_S)
        t_run = time.perf_counter() - t0
        got = run["cases"][name]
        col = got["collectives"]
        print(
            f"phase 18b {name} ({MESH_SHAPE[0]} x {MESH_SHAPE[1]} mesh, gloo, 4 ranks on one card, "
            f"{N_ITEMS // MESH_SHAPE[1]}-row slabs): {got['examples_per_s']:.1f} examples/s ({got['fit_s']:.3f} s, "
            f"{got['steps']} steps); collectives on rank 0 during the fit: {col['calls']} calls, "
            f"{col['bytes'] / 1e6:.1f} MB, {col['seconds']:.3f} s of host ({col['seconds'] / got['steps'] * 1e3:.2f} "
            f"ms and {col['bytes'] / got['steps'] / 1e6:.2f} MB a step); replicas bit-equal: "
            f"{got['replicas_equal']}; the ranks' run (this fit, its evaluation and save, the Hinge fit and "
            f"phase 18c's serving) {t_run:.1f} s, sharded save {got['save_s']:.3f} s", flush=True,
        )
        kernels = {"lstm_fwd": "K1", "lstm_bwd": "K2", "lstm_bwd_dwh": "dW_h", "gather_rows": "P1",
                   "scatter_add_rows": "P2", "cand_score_rows": "P4", "score_count_ge": "K5"}
        path = "mesh (fit-10M-sparse-mesh + eval-10M-512-mesh, rank 0 of 4)"
        print(f"launches on the {path}: {got['launches']}", flush=True)
        for k, count in got["launches"].items():
            launches[k] += count
            if count:
                launches_by_path[k][path] = count
        never = [f"{label} ({k})" for k, label in kernels.items() if not got["launches"][k]]
        if never:
            raise SmokeFailure(f"phase 18b: the mesh path never launched {never}")
        # The build keeps a slab and draws the rest a chunk at a time.
        row_bytes = (DIM + 1) * 4
        most = (-(-N_ITEMS // MESH_SHAPE[1]) + engine.INIT_CHUNK_ROWS) * row_bytes
        print(f"phase 18b build on rank 0: card memory peaked at {got['build_peak_bytes'] / 1e9:.3f} GB (its slab "
              f"and one {engine.INIT_CHUNK_ROWS}-row chunk: {most / 1e9:.3f} GB; the whole table "
              f"{N_ITEMS * row_bytes / 1e9:.3f} GB)", flush=True)
        if got["build_peak_bytes"] > most * 1.01:
            raise SmokeFailure(f"phase 18b: rank 0's build took {got['build_peak_bytes']} bytes, more than {most}")

        # Each (2, 2) fit against two world-size-1 fits on the same draws:
        # the one that runs each batch as the data axis's two shares and
        # sums them (no collective; every sum over two data ranks is one
        # a + b), held bit for bit, so the data axis's exchange of tower
        # gradients, rows and losses at full size is held exactly; and the
        # plain one, held in the loss (WARP, fit-10M-sparse's configuration)
        # and its distance printed (PERF.md §6: Adagrad's first step turns
        # the other rounding of near-zero tower gradients into +-lr).
        for case, hp in ((name, hyper), (f"{name}-hinge", hinge)):
            mine = run["cases"][case]
            plain = hp.build(dev)
            plain.fit(mat)
            shared = hp.build(dev)
            shared._data_shares = 2
            shared.fit(mat)
            table_sha = [slab_sha256(shared._params["item_table"], m, MESH_SHAPE[1]) for m in range(MESH_SHAPE[1])]
            exact = (mine["table_sha256"] == table_sha and mine["tower_sha256"] == tower_sha256(shared)
                     and mine["epoch_losses"] == shared.history.epoch_losses.tolist() and mine["replicas_equal"])
            a, b = shared._params["item_table"], plain._params["item_table"]
            beyond = int(((a - b).abs() > MESH_ATOL + MESH_RTOL * b.abs()).any(dim=1).sum())
            tower_diff = max(float((v - w).abs().max()) for (_, v), (_, w) in
                             zip(flatten(shared._params["tower"]), flatten(plain._params["tower"])))
            loss_rel = abs(mine["epoch_losses"][0] / float(plain.history.epoch_losses[0]) - 1.0)
            print(f"phase 18b {case}: epoch loss {mine['epoch_losses'][0]:.6f}; bit-equal to the two-share "
                  f"world-size-1 fit (losses, both slabs and the tower, sha256): {exact}; against the plain "
                  f"world-size-1 fit: loss {float(plain.history.epoch_losses[0]):.6f} ({loss_rel:.3e} apart), "
                  f"table largest difference {float((a - b).abs().max()):.3e}, {beyond} of {N_ITEMS} rows past "
                  f"rtol {MESH_RTOL} / atol {MESH_ATOL}, tower largest difference {tower_diff:.3e}", flush=True)
            if not exact:
                raise SmokeFailure(f"phase 18b: the {case} fit differs from the two-share world-size-1 fit")
            if case == name:
                if loss_rel > 1e-4:
                    raise SmokeFailure(f"phase 18b: the {case} loss is {loss_rel:.3e} from the world-size-1 loss")
                ref, ref_shared = plain, shared
            del a, b, plain, shared
        torch.cuda.empty_cache()

        # ckpt-10M-sharded at world size 1: the whole table the ranks saved
        # is the two-share fit's.
        t0 = time.perf_counter()
        copy = ImplicitSequenceModel.load(os.path.join(tmp, "ws4"), dev)
        t_load = time.perf_counter() - t0
        if not all(torch.equal(v, w) for (_, v), (_, w) in zip(flatten(copy._params), flatten(ref_shared._params))):
            raise SmokeFailure("phase 18b: the sharded save, loaded at world size 1, is not the fitted model")
        print(f"phase 18b ckpt-10M-sharded loaded at world size 1 in {t_load:.3f} s, bit-equal to the two-share "
              f"fit", flush=True)
        ref_sha = [slab_sha256(ref._params["item_table"], m, 2) for m in range(2)]
        ref_tower = tower_sha256(ref)
        del ref, ref_shared
        torch.cuda.empty_cache()

        # eval-10M-512-mesh: the ranks of K5 per slab against the world-size-1
        # ranks of the same parameters.
        ranks_ws1 = evaluation._ranks_batched(copy, test)
        ranks_mesh = run["arrays"][f"{name}.ranks"]
        print(f"phase 18b eval-10M-{EVAL_USERS[0]}-mesh: MRR {got['mrr']:.9f} in {got['eval_s'] * 1e3:.1f} ms "
              f"(K5 on each slab, lo = 0 and {-(-N_ITEMS // MESH_SHAPE[1])}); world size 1: MRR "
              f"{float(np.mean(1.0 / ranks_ws1)):.9f}", flush=True)
        check_ranks("phase 18b", copy, test, {"mesh (K5 per slab)": ranks_mesh}, ranks_ws1, torch,
                    against="world size 1 (K5 on the whole table)")

        serve_mesh_phase(run, served, mark, launches, launches_by_path)

        # Two ranks, (1, 2): the row-sharded fit alone, bit-equal to world
        # size 1; then ckpt-10M-sharded loaded, each slab bit-equal to the
        # world-size-1 load.
        spec2 = {"backend": "gloo", "device": "cuda", "timeout_s": MESH_COLLECTIVE_TIMEOUT_S, "inputs": None,
                 "out": os.path.join(tmp, "out2.npz"),
                 "cases": [{"name": "fit-m2", "family": "lstm", "hyper": hyper.to_dict(), "mesh": [1, 2],
                            "data": [FIT_USERS, N_ITEMS, FIT_ITEMS_PER_USER, 0], "fit": True, "sha256": True},
                           {"name": "ws2", "load": os.path.join(tmp, "ws4"), "mesh": [1, 2], "sha256": True}]}
        t0 = time.perf_counter()
        run2 = launch(2, spec2, os.path.join(tmp, "spec2.json"), MESH_TIMEOUT_S)["cases"]
        t_ws2 = time.perf_counter() - t0
        fit2 = run2["fit-m2"]
        if fit2["table_sha256"] != ref_sha or fit2["tower_sha256"] != ref_tower or not fit2["replicas_equal"]:
            raise SmokeFailure("phase 18b: the (1, 2) fit is not bit-equal to the world-size-1 fit")
        loaded_sha = [slab_sha256(copy._params["item_table"], m, 2) for m in range(2)]
        if run2["ws2"]["table_sha256"] != loaded_sha:
            raise SmokeFailure("phase 18b: a slab loaded at world size 2 differs from the world-size-1 load")
        print(f"phase 18b two ranks ({t_ws2:.1f} s with their start): a (1, 2) fit-10M-sparse fit "
              f"({fit2['examples_per_s']:.1f} examples/s, {fit2['collectives']['seconds']:.3f} s of host in "
              f"{fit2['collectives']['calls']} collectives) bit-equal to the world-size-1 fit (both slabs and the "
              f"tower, sha256); ckpt-10M-sharded loaded at world size 2, both slabs bit-equal to the world-size-1 "
              f"load", flush=True)
        del copy
        torch.cuda.empty_cache()

        if torch.cuda.device_count() >= 2:
            world = 4 if torch.cuda.device_count() >= 4 else 2
            spec3 = {"backend": "nccl", "device": "cuda", "timeout_s": MESH_COLLECTIVE_TIMEOUT_S, "inputs": None,
                     "out": os.path.join(tmp, "out_nccl.npz"),
                     "cases": [{"name": name, "family": "lstm", "hyper": hyper.to_dict(), "mesh": [world // 2, 2],
                                "data": [FIT_USERS, N_ITEMS, FIT_ITEMS_PER_USER, 0], "fit": True}]}
            nccl = launch(world, spec3, os.path.join(tmp, "spec_nccl.json"), MESH_TIMEOUT_S)["cases"][name]
            print(f"phase 18b {name} over NCCL, one rank a card ({world // 2} x 2): {nccl['examples_per_s']:.1f} "
                  f"examples/s, epoch loss {nccl['epoch_losses'][0]:.6f}", flush=True)
            if not nccl["replicas_equal"] or not np.allclose(nccl["epoch_losses"], got["epoch_losses"], rtol=1e-4,
                                                             atol=0):
                raise SmokeFailure(f"phase 18b: the NCCL fit's losses {nccl['epoch_losses']}")
        else:
            print("phase 18b NCCL, one rank a card: skipped (one card)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18b-18c: {time.perf_counter() - t_phase:.1f} s in all", flush=True)


# Phase 18c's cells: name -> (catalog, seed, table copies, batches timed
# after a warm-up, routes: {route: (class constants set on the model, world
# size 1's lists of the same model in ``served``)}).
SERVE_MESH_CELLS = {
    "serve-10M-mesh": (N_ITEMS, 42, None, 3, {
        "default": ({}, "serve-10M"),
        "phase2": ({"_PHASE2_BUFFER_BYTES": CONSTANT_BUDGETS["_PHASE2_BUFFER_BYTES"]}, "serve-10M"),
        # All three fixed: no reading and no all-gather of the readings.
        "constants": (CONSTANT_BUDGETS, "serve-10M")}),
    "serve-1M-merge-mesh": (N_ITEMS_MERGE, 42, None, 1, {"merge": ({"_MERGE_BUFFER_BYTES": 0}, "serve-1M-merge")}),
    "copies-mesh": (N_ITEMS_MERGE, 43, REPEATS, 1,
                    {"single": ({}, "copies"), "merge": ({"_MERGE_BUFFER_BYTES": 0}, "copies-merge")}),
}
MESH_SERVE_KERNELS = ("lstm_fwd", "score_submax_groupmax", "score_submax_groupmax_fp32", "score_groupmax",
                      "score_groupmax_fp32")


def serve_mesh_cases(served):
    """Phase 18c's cases of the four ranks' spec: each cell's model built
    on the mesh (the copies made on each slab), serving world size 1's
    histories."""
    cases = []
    for name, (num_items, seed, copies, repeats, routes) in SERVE_MESH_CELLS.items():
        histories = served[next(iter(routes.values()))[1]][0]
        case = {"name": name, "family": "lstm", "hyper": serving_hyper(num_items, seed).to_dict(),
                "mesh": list(MESH_SHAPE),
                "recommend": {"histories": histories, "k": K, "repeats": repeats,
                              "routes": {route: constants for route, (constants, _) in routes.items()}}}
        if copies:
            case["copies"] = copies
        cases.append(case)
    return cases


def serve_mesh_phase(run, served, mark, launches, launches_by_path):
    """Phase 18c: the four ranks' ``recommend_batch`` on the (2, 2) mesh,
    each rank a slab (5,000,000 rows at 10M items, 500,000 at 1M): every
    cell's lists against world size 1's (phases 4, 5, 5b, 5c: scores within
    TOL_REL relative, ids except at ties), the four ranks' ids, scores and
    ``predict`` scores bit-equal, the copies rechecked on every slab, and
    the path's launches of K1, K4, K3 and both FP32 routes (rank 0's)."""
    mark("phase 18c")
    totals = {}
    for name, (num_items, _, copies, repeats, routes) in SERVE_MESH_CELLS.items():
        got = run["cases"][name]["recommend"]
        if len(got["sha256"]) != MESH_SHAPE[0] * MESH_SHAPE[1] or len(set(got["sha256"])) != 1:
            raise SmokeFailure(f"phase 18c {name}: the ranks serve other bits ({got['sha256']})")
        for route, (_, key) in routes.items():
            histories, want_ids, want_vals = served[key]
            r = got["routes"][route]
            ids = run["arrays"][f"{name}.{route}.ids"]
            vals = run["arrays"][f"{name}.{route}.vals"]
            check_lists(f"phase 18c {name} {route}", ids.tolist(), histories, num_items)
            ties = check_same_lists(f"phase 18c {name} {route}", ids, vals, np.asarray(want_ids), want_vals)
            col = r["collectives"]
            n_loc = -(-num_items // MESH_SHAPE[1])
            taken = r["stream_route"]
            if taken is None:
                rank0_route = "no streamed top-k"
            else:
                b = taken["budgets_bytes"]
                rank0_route = (f"merge {b[0] / 1e9:.2f} GB, submax {b[1] / 1e9:.2f} GB, phase 2 {b[2] / 1e9:.2f} GB; "
                               + describe_route(types.SimpleNamespace(**taken["route"]), n_loc,
                                                min(K + max(len(h) for h in histories), n_loc)))
            print(f"phase 18c {name} {route} ({MESH_SHAPE[0]} x {MESH_SHAPE[1]} mesh, gloo, 4 ranks on one card, "
                  f"{-(-num_items // MESH_SHAPE[1])}-row slabs, U={len(histories)}, k={K}): "
                  f"{r['users_per_s']:.1f} users/s (median of {repeats}: "
                  f"{', '.join(f'{t * 1e3:.1f}' for t in r['batch_s'])} ms a batch); rank 0's collectives a batch: "
                  f"{col['calls']:g} calls, {col['bytes'] / 1e6:.2f} MB, {col['seconds'] * 1e3:.1f} ms of host; "
                  f"rechecked in the last batch: {r['rechecked']} on rank 0, {r['rechecked_sum']} over the ranks; "
                  f"the lists of world size 1 ({key}) with {ties} tied ranks; the four ranks bit-equal; rank 0's "
                  f"budgets and route: {rank0_route}", flush=True)
            if copies and r["rechecked"] != len(histories):
                raise SmokeFailure(f"phase 18c {name} {route}: {r['rechecked']} users rechecked on rank 0, not all "
                                   f"{len(histories)}: every slab's top-10 ties")
        for k, count in got["launches"].items():
            totals[k] = totals.get(k, 0) + count
    path = "mesh-serve"
    print(f"launches on the {path} path (phase 18c, rank 0 of 4): {totals}", flush=True)
    for k, count in totals.items():
        launches[k] += count
        if count:
            launches_by_path[k][path] = count
    never = [k for k in MESH_SERVE_KERNELS if not totals[k]]
    if never:
        raise SmokeFailure(f"phase 18c: the mesh-serve path never launched {never}")


def tower_sha256(model):
    """sha256 of the bytes of ``model``'s tower leaves, in path order."""
    import torch
    from sbr_rs_tpu_torch.utils.tree import flatten

    return hashlib.sha256(b"".join(v.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                   for _, v in flatten(model._params["tower"]))).hexdigest()


def slab_sha256(table, m, model):
    """sha256 of slab ``m`` of ``model`` of ``table``'s rows (as
    ``parallel.sharding.slab_range`` cuts it), hashed 1M rows at a time."""
    import torch

    n = table.shape[0]
    n_loc = -(-n // model)
    h = hashlib.sha256()
    for a in range(m * n_loc, min((m + 1) * n_loc, n), 1 << 20):
        h.update(table[a : min(a + (1 << 20), (m + 1) * n_loc, n)].contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def trace_serve_batch(log_dir):
    """Phase 16's process: serve-10M's model, one batch to warm up, then one
    batch under ``utils.metrics.trace(log_dir)``."""
    import torch
    from sbr_rs_tpu_torch.utils.metrics import trace

    model = serving_model(N_ITEMS, torch.device("cuda", 0))
    histories = serving_histories(N_ITEMS)
    model.recommend_batch(histories, k=K)
    with trace(log_dir):
        model.recommend_batch(histories, k=K)


def budget_sides(label, model, histories, after=None):
    """Both sides of the serving budgets (:func:`serve_side`): the card's,
    then the JAX package's constants; ``after(side, result)`` runs at the
    end of each, on its budgets. The two sides' lists agree (scores within
    TOL_REL relative, ids except at ties). Returns ``{side: result}``."""
    sides = {}
    for side, constants in (("card", {}), ("constants", CONSTANT_BUDGETS)):
        sides[side] = serve_side(label, model, histories, side, constants,
                                 None if after is None else functools.partial(after, side))
    ties = check_same_lists(f"{label}, the constants' lists against the card's", sides["constants"]["ids"],
                            sides["constants"]["vals"], sides["card"]["ids"], sides["card"]["vals"])
    print(f"  {label}: the two sides serve the same lists ({ties} tied ranks)", flush=True)
    return sides


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


def check_same_lists(phase, ids, vals, want_ids, want_vals):
    """Lists ``[U, K]`` against another run's: scores within TOL_REL
    relative, ids equal except where the other run's scores tie within it.
    Returns the tied ranks."""
    bound = TOL_REL * np.abs(want_vals) + 1e-12
    if ids.shape != want_ids.shape or not np.all(np.abs(vals - want_vals) <= bound):
        raise SmokeFailure(f"{phase}: scores differ (worst relative "
                           f"{float(np.max(np.abs(vals - want_vals) / np.abs(want_vals))):.2e})")
    gap = np.abs(np.diff(want_vals, axis=1)) <= TOL_REL * np.abs(want_vals[:, 1:])
    tied = np.zeros(want_ids.shape, dtype=bool)
    tied[:, :-1] |= gap
    tied[:, 1:] |= gap
    if ((ids != want_ids) & ~tied).any():
        raise SmokeFailure(f"{phase}: ids differ at {int(((ids != want_ids) & ~tied).sum())} untied ranks")
    return int(tied.sum())


def check_ranks(phase, model, test, ranks, generic, torch, against="the per-user loop"):
    """Each of ``ranks`` (name -> ranks of the qualifying users) against
    ``generic`` (the per-user loop's, or ``against``): equal, except that a user's ranks may
    differ by as many items as score within TOL_SCORE of its held-out item
    (plain f32 scores of the whole catalog, seen items masked)."""
    from sbr_rs_tpu_torch import evaluation

    n = test.num_items
    users = np.flatnonzero(np.diff(test.user_pointers) >= 2)
    reps, prefix, test_items, _ = evaluation._batch_inputs(model, test, users, n)
    table = model._params["item_table"][:n].float()
    near = []
    for i in range(0, len(users), 64):  # [64, n] scores at a time
        scores = reps[i : i + 64] @ table[:, :-1].T + table[:, -1]
        rows = torch.arange(scores.shape[0], device=scores.device)
        p = prefix[i : i + 64]
        mask = torch.zeros((scores.shape[0], n + 1), dtype=torch.bool, device=scores.device)
        scores.masked_fill_(mask.scatter_(1, p, True)[:, :n], evaluation._NEG_MIN)
        target = scores[rows, test_items[i : i + 64]]
        near.append((((scores - target[:, None]).abs() <= TOL_SCORE).sum(dim=1) - 1).cpu().numpy())
    near = np.concatenate(near)
    for name, r in ranks.items():
        diff = np.abs(np.asarray(r) - generic)
        if r.shape != generic.shape or (diff > near).any():
            raise SmokeFailure(f"{phase}: {name} ranks differ from the per-user loop beyond near-ties")
        print(
            f"  {phase}: {name} ranks of {len(users)} users against {against}: "
            f"{int((diff > 0).sum())} differ (by at most {int(diff.max())}); "
            f"{int((near > 0).sum())} users have another item within {TOL_SCORE:.0e} of the target",
            flush=True,
        )


def check_against_reference(phase, model, histories, ids, vals, tower, torch):
    """The same users through a plain reference: the plain tower (``tower(
    params, x)``, the LSTM's plain loop for the LSTM) on the same
    parameters, one torch.matmul per catalog chunk, seen items masked,
    a running torch.topk of K + 1 over the chunks. Scores agree within TOL_REL
    relative; ids agree except where the reference's own scores tie within
    that tolerance."""
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
    with torch.no_grad():
        hidden = tower(params["tower"], emb)
    reps = hidden[torch.arange(u, device=dev), torch.from_numpy(last).to(dev)]
    # A running top-(K+1) over the catalog, chunk by chunk: a dense [U, N]
    # score matrix would not fit beside a 50M-item table.
    width = max(len(set(h)) for h in histories)
    seen = torch.full((u, max(width, 1)), -1, dtype=torch.int64, device=dev)
    for i, h in enumerate(histories):
        seen[i, : len(set(h))] = torch.tensor(sorted(set(h)), device=dev)
    rows = torch.arange(u, device=dev)[:, None].expand_as(seen)
    ref_v = torch.full((u, K + 1), float("-inf"), device=dev)
    ref_i = torch.full((u, K + 1), -1, dtype=torch.int64, device=dev)
    for lo in range(0, n, SERVE_CHUNK):
        chunk = table[lo : lo + SERVE_CHUNK].float()
        scores = reps @ chunk[:, :-1].T + chunk[:, -1]
        local = seen - lo
        hit = (local >= 0) & (local < chunk.shape[0])
        scores[rows[hit], local[hit]] = float("-inf")
        cv, cp = torch.topk(scores, min(K + 1, chunk.shape[0]), dim=1)
        ref_v, p = torch.topk(torch.cat([ref_v, cv], dim=1), K + 1, dim=1)
        ref_i = torch.gather(torch.cat([ref_i, lo + cp], dim=1), 1, p)
    ref_v, ref_i = ref_v.cpu().numpy(), ref_i.cpu().numpy()
    got_i = np.asarray(ids)
    got_v = np.asarray(vals)
    bound = TOL_REL * np.abs(ref_v[:, :K]) + 1e-12
    if not np.all(np.abs(got_v - ref_v[:, :K]) <= bound):
        worst = float(np.max(np.abs(got_v - ref_v[:, :K]) / np.abs(ref_v[:, :K])))
        raise SmokeFailure(f"{phase}: scores differ from the reference (worst relative {worst:.2e})")
    got_rows = table[torch.from_numpy(got_i).to(dev)].float()  # [U, K, C]
    own = ((got_rows[:, :, :-1] @ reps[:, :, None])[:, :, 0] + got_rows[:, :, -1]).cpu().numpy()
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
