#!/usr/bin/env python3
"""One rank of a multi-process run of the PyTorch port: fits, evaluations,
sharded saves and loads over a ``(data, model)`` mesh of ranks. The port's
counterpart of ``scripts/multiprocess_fit.py``; it imports torch and the
port, never jax.

    python scripts/torch_multiprocess_fit.py WORLD RANK PORT SPEC.json

starts rank ``RANK`` of ``WORLD``; the ranks meet at ``tcp://127.0.0.1:PORT``
(:func:`launch` starts them all and waits with a time limit). ``SPEC.json``
holds ``backend`` (``"gloo"`` or ``"nccl"``), ``device`` (``"cpu"`` or
``"cuda"``), ``timeout_s`` (the limit of each collective), ``inputs`` (a
``.npz`` of initial parameters and draws, or null), ``out`` (the ``.npz``
rank 0 writes) and ``cases``, run in order, each with its own mesh:

* ``name``, ``family`` (``lstm``, ``ewma``, ``gru``, ``attention``),
  ``hyper`` (``Hyperparameters.to_dict()``), ``mesh`` (``[data, model]``);
* ``data``: ``[users, items, per_user, rng]`` of
  ``datasets.synthetic_interactions``, the interactions to fit (and, with
  ``eval`` true, to evaluate);
* ``load``: a checkpoint directory to load (every rank its slab) instead
  of building from ``hyper``; ``init``: load ``<name>.init.<path>`` from
  the inputs as the initial parameters; ``draws``: fit with the epoch
  permutations ``<name>.perm`` and candidates ``<name>.cand`` of the
  inputs instead of the model's own draws;
* ``fit``, ``eval`` (``[users, items, per_user, rng]`` of the test set, or
  true for ``data``), ``save`` (a directory), ``gather`` (write the whole
  parameters), ``clone`` (after the fit, fit a clone and the model once
  more each: their losses and parameters must be equal bit for bit),
  ``check_rows`` (the sharded row gather and candidate scores against the
  plain ones on the whole of a random table, bit for bit), ``sha256`` (the
  sha256 of each slab of the table, in the model axis's order, and of the
  tower's leaves), ``serve`` (the representations of a few histories and
  the first one's ``predict`` scores over the catalog), ``copies`` (``r``:
  before anything else, make the table ``r`` copies of its first ``N / r``
  rows, item ``i``'s row at ``i + j * N / r``, every rank its slab),
  ``recommend`` (``{"histories": [...] or null for SERVE_HISTORIES, "k",
  "repeats", "routes": {route: {class constant: value}}}``: for each route,
  the constants set on the model, ``recommend_batch(return_scores=True)``
  once to warm up when ``repeats > 1``, then ``repeats`` timed batches).

Rank 0 writes ``<name>.epoch_losses``, ``<name>.ranks``, ``<name>.reps``,
``<name>.scores``, ``<name>.<route>.ids`` and ``<name>.<route>.vals`` and,
with ``gather``, ``<name>.params.<path>`` to ``out``, and prints one JSON
line per run: the process group's size, each case's mesh (made with the
spec's ``device`` as every rank's), losses, MRR,
fit seconds and examples/s, the card memory the build or load peaked at,
the checkpoint's hash, the host seconds, calls and bytes of the
collectives during the fit, the kernels' launches during the fit and the
evaluation, whether the replicas along the data axis (and the tower on
every rank) are bit-equal, the results of ``clone`` and ``check_rows``,
and for ``recommend`` each route's users/s (the median batch), rank 0's
collectives a batch, the users the certificate rechecked in the last
batch (rank 0's and the sum over the ranks), the budgets and route of
rank 0's streamed top-k in the last batch (null where its slab took
another route), the kernels' launches over all the routes' batches, and each rank's sha256 of every route's last ids
and scores and of ``predict``'s scores of the first history.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The histories the ``serve`` flag represents (ids below 40).
SERVE_HISTORIES = [[1, 2, 3], [30, 39], [5, 5, 7, 11, 13, 17, 19, 23, 29], [0]]


def _digest(tensors, device):
    """sha256 of the tensors' bytes, as 32 int32 values (one per byte) on
    ``device`` (a tensor the backend's collectives take)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        for a in range(0, flat.numel(), 1 << 26):
            h.update(flat[a : a + (1 << 26)].cpu().numpy())
    return torch.tensor(list(h.digest()), dtype=torch.int32, device=device)


def _replicas_equal(model, mesh) -> bool:
    """Whether every rank holds the same bits as the ranks it replicates:
    the table slab and its tower along the data axis, the tower on every
    rank."""
    import torch

    from sbr_rs_tpu_torch.parallel.mesh import DATA_AXIS
    from sbr_rs_tpu_torch.utils.tree import flatten

    tower = [v for _, v in flatten(model._params["tower"])]
    slab = _digest([model._params["item_table"]] + tower, model.device)
    same = all(torch.equal(p, slab) for p in mesh.all_gather(slab, DATA_AXIS))
    tw = _digest(tower, model.device)
    same &= all(torch.equal(p, tw) for p in mesh.all_gather(tw, None))
    flag = torch.tensor([0 if same else 1], dtype=torch.int32, device=model.device)
    return int(mesh.all_reduce(flag, None)) == 0


def _check_rows(mesh, model, device) -> bool:
    """The sharded gather and candidate scores on this rank's slab of a
    random table (with some -0.0 entries) equal the plain ones on the whole
    table, bit for bit, on every rank."""
    import torch

    from sbr_rs_tpu_torch.ops.row_kernels import cand_score, gather_rows
    from sbr_rs_tpu_torch.parallel.sharding import cand_score_sharded, gather_rows_sharded, slab_range

    n, c = model.hyper._num_items, model.hyper._item_embedding_dim + 1
    gen = torch.Generator(device=device).manual_seed(11)
    table = torch.randn((n, c), generator=gen, device=device)
    table[torch.rand((n, c), generator=gen, device=device) < 0.1] = -0.0
    lo, hi = slab_range(mesh, n)
    idx = torch.randint(0, n, (97,), generator=gen, device=device)
    haug = torch.randn((31, c), generator=gen, device=device)
    cand = torch.randint(0, n, (31, 5), generator=gen, device=device)
    rows = gather_rows_sharded(table[lo:hi].clone(), idx, mesh, n)
    scores = cand_score_sharded(haug, table[lo:hi].clone(), cand, mesh, n)
    same = torch.equal(rows.view(torch.int32), gather_rows(table, idx).view(torch.int32))
    same &= torch.equal(scores.view(torch.int32), cand_score(haug, table, cand).view(torch.int32))
    flag = torch.tensor([0 if same else 1], dtype=torch.int32, device=device)
    return int(mesh.all_reduce(flag, None)) == 0


def _clone_fits_alike(model, data) -> bool:
    """A clone's next fit equals the model's next fit, bit for bit."""
    import torch

    from sbr_rs_tpu_torch.utils.tree import flatten

    twin = model.clone()
    if twin.hyper._mesh is not model.hyper._mesh:
        return False
    same = twin.fit(data) == model.fit(data)
    pairs = zip(flatten(twin._params), flatten(model._params))
    return same and all(torch.equal(a, b) for (_, a), (_, b) in pairs)


def _counters():
    from sbr_rs_tpu_torch.ops import lstm_kernels as lk
    from sbr_rs_tpu_torch.ops import row_kernels as rowk
    from sbr_rs_tpu_torch.ops import topk_kernels as tk

    return {
        "lstm_fwd": lk.lstm_fwd, "lstm_bwd": lk.lstm_bwd, "lstm_bwd_dwh": lk.lstm_bwd_dwh,
        "gather_rows": rowk.gather_rows, "scatter_add_rows": rowk.scatter_add_rows_,
        "cand_score_smem": rowk.cand_score_smem, "cand_score_rows": rowk.cand_score_rows,
        "score_count_ge": tk.score_count_ge, "score_groupmax": tk.score_groupmax,
        "score_groupmax_fp32": tk.score_groupmax_fp32, "score_submax_groupmax": tk.score_submax_groupmax,
        "score_submax_groupmax_fp32": tk.score_submax_groupmax_fp32,
    }


def _copies(model, r: int) -> None:
    """Make the model's table ``r`` copies of its first ``N / r`` rows, in
    place: each rank its slab, cut from the whole table."""
    import torch

    from sbr_rs_tpu_torch.parallel.sharding import slab_range

    n = model.hyper._num_items
    lo, hi = slab_range(model.hyper._mesh, n)
    whole = model._full_table()
    rows = torch.arange(lo, hi, device=whole.device) % (n // r)
    model._params["item_table"].copy_(whole.index_select(0, rows))


def _recommend(model, mesh, spec, name, out, device) -> dict:
    """The ``recommend`` flag: each route's batches, timed; see the module
    docstring."""
    import torch

    from sbr_rs_tpu_torch.models.base import topk_streamed

    histories = spec.get("histories") or SERVE_HISTORIES
    k, repeats = spec.get("k", 5), spec.get("repeats", 1)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    result, digests = {"routes": {}}, []
    for route, constants in spec["routes"].items():
        for key, value in constants.items():
            setattr(model, key, value)
        if repeats > 1:
            model.recommend_batch(histories, k=k, return_scores=True)
        times, before = [], dict(mesh.stats)
        for _ in range(repeats):
            topk_streamed.last_route = None
            checked = topk_streamed.rechecked_users
            t0 = time.perf_counter()
            ids, vals = model.recommend_batch(histories, k=k, return_scores=True)
            times.append(time.perf_counter() - t0)
        rechecked = topk_streamed.rechecked_users - checked
        total = torch.tensor([rechecked], dtype=torch.int64, device=device)
        ids = np.asarray(ids, dtype=np.int64)
        taken = topk_streamed.last_route  # this rank's streamed top-k: its route and budgets
        result["routes"][route] = {
            "users_per_s": len(histories) / float(np.median(times)), "batch_s": times,
            "collectives": {key: (mesh.stats[key] - before[key]) / repeats for key in before},
            "rechecked": rechecked, "rechecked_sum": int(mesh.all_reduce(total, None)),
            "stream_route": None if taken is None else {"route": taken[0]._asdict(), "budgets_bytes": list(taken[1])},
        }
        out[f"{name}.{route}.ids"], out[f"{name}.{route}.vals"] = ids, vals
        digests += [torch.from_numpy(ids), torch.from_numpy(np.ascontiguousarray(vals))]
        for key in constants:
            delattr(model, key)
    result["launches"] = {key: fn.launches for key, fn in counters.items()}
    predict = model.predict(model.user_representations(histories[:1])[0])
    out[f"{name}.predict"] = predict
    digests.append(torch.from_numpy(predict))
    parts = mesh.all_gather(_digest(digests, device), None)
    result["sha256"] = [bytes(p.cpu().numpy().astype(np.uint8).tolist()).hex() for p in parts]
    return result


def run_case(case, inputs, spec, out):
    import torch

    from sbr_rs_tpu_torch import datasets, evaluation, models
    from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
    from sbr_rs_tpu_torch.parallel import make_mesh
    from sbr_rs_tpu_torch.utils.tree import flatten, unflatten

    name = case["name"]
    data, model_axis = case["mesh"]
    mesh = make_mesh(data, model_axis, devices=[spec["device"]] * (data * model_axis))
    device = mesh.device
    result = {"mesh": [mesh.data, mesh.model]}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if case.get("load"):
        model = ImplicitSequenceModel.load(case["load"], device, mesh=mesh)
    else:
        family = getattr(models, case["family"])
        model = family.Hyperparameters.from_dict(case["hyper"]).mesh(mesh).build(device)
    if device.type == "cuda":
        result["build_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if case.get("copies"):
        _copies(model, case["copies"])
    if case.get("init"):
        prefix = f"{name}.init."
        keys = sorted(k for k in inputs.files if k.startswith(prefix))
        model.load_numpy_params(unflatten([k[len(prefix):] for k in keys], [inputs[k] for k in keys]))
    if case.get("draws"):
        perm, cand = inputs[f"{name}.perm"], inputs[f"{name}.cand"]

        def permutation(epoch, n):
            return torch.from_numpy(perm[epoch].astype(np.int64)).to(device)

        def candidates(step, shape):
            if tuple(cand[step].shape) != tuple(shape):
                raise ValueError(f"draw of step {step} has shape {cand[step].shape}, the fit asks {shape}")
            return torch.from_numpy(cand[step].astype(np.int64)).to(device)

        model._epoch_permutation = permutation
        model._step_candidates = candidates

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    if case.get("fit"):
        data = datasets.synthetic_interactions(*case["data"][:3], rng=case["data"][3]).to_compressed()
        before = dict(mesh.stats)
        t0 = time.perf_counter()
        loss = model.fit(data)
        if device.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        h = model.history
        result.update(
            loss=loss, epoch_losses=h.epoch_losses.tolist(), fit_s=fit_s,
            examples_per_s=h.examples_per_epoch * h.num_epochs / fit_s,
            steps=int(h.num_epochs * -(-model._windows(data)[3] // model.hyper._batch_size)),
            collectives={k: mesh.stats[k] - before[k] for k in before},
        )
        out[f"{name}.epoch_losses"] = h.epoch_losses
    if case.get("eval"):
        spec_eval = case["data"] if case["eval"] is True else case["eval"]
        test = datasets.synthetic_interactions(*spec_eval[:3], rng=spec_eval[3]).to_compressed()
        t0 = time.perf_counter()
        ranks = evaluation._ranks(model, test)
        result["eval_s"] = time.perf_counter() - t0
        result["mrr"] = float(np.mean(1.0 / ranks.astype(np.float64)))
        out[f"{name}.ranks"] = ranks
    if case.get("sha256"):
        from sbr_rs_tpu_torch.parallel.mesh import MODEL_AXIS

        def hexdigest(d):
            return bytes(d.cpu().numpy().astype(np.uint8).tolist()).hex()

        parts = mesh.all_gather(_digest([model._params["item_table"]], device), MODEL_AXIS)
        result["table_sha256"] = [hexdigest(p) for p in parts]
        result["tower_sha256"] = hexdigest(_digest([v for _, v in flatten(model._params["tower"])], device))
    result["launches"] = {k: fn.launches for k, fn in counters.items()}
    result["replicas_equal"] = _replicas_equal(model, mesh)
    if case.get("clone"):
        result["clone_fits_alike"] = _clone_fits_alike(model, data)
    if case.get("serve"):
        reps = model.user_representations(SERVE_HISTORIES)
        out[f"{name}.reps"] = np.stack([r.user_embedding for r in reps])
        out[f"{name}.scores"] = model.predict(reps[0])
    if case.get("recommend"):
        result["recommend"] = _recommend(model, mesh, case["recommend"], name, out, device)
    if case.get("check_rows"):
        result["rows_bit_equal"] = _check_rows(mesh, model, device)
    if case.get("save"):
        t0 = time.perf_counter()
        model.save(case["save"])
        result["save_s"] = time.perf_counter() - t0
        with open(os.path.join(case["save"], "config.json")) as f:
            result["state_sha256"] = json.load(f)["state_sha256"]
    if case.get("gather"):
        table = model._full_table()
        out[f"{name}.params.item_table"] = table.float().cpu().numpy()
        for path, v in flatten(model._params["tower"]):
            out[f"{name}.params.tower.{path}"] = v.cpu().numpy()
    return result


def main() -> None:
    world_size, rank, port, spec_path = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from sbr_rs_tpu_torch import parallel

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["backend"] == "nccl":
        os.environ.setdefault("LOCAL_RANK", str(rank))
    parallel.initialize(
        f"127.0.0.1:{port}", num_processes=world_size, process_id=rank, backend=spec["backend"],
        timeout_s=spec.get("timeout_s", 120),
    )
    joined = parallel.mesh.world()  # the process group's (size, rank)
    inputs = np.load(spec["inputs"]) if spec.get("inputs") else None
    out, results = {}, {}
    try:
        for case in spec["cases"]:
            results[case["name"]] = run_case(case, inputs, spec, out)
    finally:
        parallel.shutdown()
    if rank == 0:
        np.savez(spec["out"], **out)
        print(json.dumps({"world": joined[0], "backend": spec["backend"], "cases": results}), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world_size: int, spec: dict, spec_path: str, timeout_s: float, env=None) -> dict:
    """Write ``spec`` to ``spec_path``, run ``world_size`` ranks of this
    script on it and wait at most ``timeout_s`` seconds for all of them;
    on the limit, or when a rank fails, kill every rank and raise
    ``RuntimeError`` with the ranks' last error output. Each rank writes its
    output to files beside ``spec_path`` (a pipe read late could block a
    rank and stall every collective). Returns rank 0's JSON line with its
    ``out`` arrays under ``"arrays"``."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    logs = [(f"{spec_path}.rank{r}.out", f"{spec_path}.rank{r}.err") for r in range(world_size)]
    procs = []
    for r, (out_path, err_path) in enumerate(logs):
        with open(out_path, "w") as out, open(err_path, "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(world_size), str(r), str(port), spec_path],
                stdout=out, stderr=err, text=True, env=env, cwd=ROOT,
            ))

    def tail(path, n):
        with open(path, errors="replace") as f:
            return f.read()[-n:]

    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        errs = [tail(err, 1500) for _, err in logs]
        raise RuntimeError(f"the {world_size} ranks did not finish in {timeout_s} s: {errs}") from None
    failed = [(r, p.returncode, tail(logs[r][1], 3000)) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    line = [ln for ln in tail(logs[0][0], 1 << 30).splitlines() if ln.startswith("{")][-1]
    result = json.loads(line)
    with np.load(spec["out"]) as arrays:
        result["arrays"] = {k: arrays[k] for k in arrays.files}
    return result


if __name__ == "__main__":
    main()
