"""The port's parallel layer (``sbr_rs_tpu_torch.parallel``) on the CPU,
against the port itself: the mesh's rules, the sharding rules, and sharded
fits, evaluations and serving in several gloo processes against the
one-rank model on the same draws or parameters.

Every rank draws from the same seeded generators, so a sharded fit sees the
one-rank fit's permutations and candidates (and attention's dropout masks,
drawn at the whole batch's shape and sliced). The sums associate otherwise
(each rank's share of the batch, then a sum over the data axis), so the
epoch losses are held to rtol 1e-4 and the parameters to rtol 2e-4 / atol
1e-3, the tolerances of ``tests/test_torch_fit.py``; the replicas along the
data axis must be equal bit for bit, and a world-size-1 mesh changes no
bit. Every fitted model then serves on every route of ``recommend_batch``
(under a model axis each slab's top-k and the cross-shard merge), as does a
catalog the model axis splits unevenly: the lists of the one-rank model on
the gathered parameters (scores 1e-5 relative, ids except at ties), every
rank's bits alike. The ranks run ``scripts/torch_multiprocess_fit.py`` in subprocesses
(they import no jax), one group per world size, each group killed and
failed after 120 s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch import datasets, evaluation
from sbr_rs_tpu_torch.models import Loss, Optimizer, attention, base, engine, ewma, gru, lstm
from sbr_rs_tpu_torch.models.engine import init_opt_state
from sbr_rs_tpu_torch.parallel import make_mesh
from sbr_rs_tpu_torch.parallel.mesh import mesh_shape
from sbr_rs_tpu_torch.parallel.sharding import batch_slice, param_specs, shard_model_params, slab_range
from sbr_rs_tpu_torch.utils import checkpoint
from sbr_rs_tpu_torch.utils.tree import flatten, unflatten

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts.torch_multiprocess_fit import SERVE_HISTORIES, launch  # noqa: E402

RTOL, ATOL = 2e-4, 1e-3
NUM_ITEMS = 64
DATA = [40, NUM_ITEMS, 15, 0]  # synthetic_interactions(users, items, per_user, rng)
GROUP_TIMEOUT_S = 120
FAMILIES = {"lstm": lstm, "ewma": ewma, "gru": gru, "attention": attention}


def _hyper(family, loss, kind, packed, sparse, dropout=0.0, num_items=NUM_ITEMS):
    hp = (
        FAMILIES[family].Hyperparameters(num_items, 8)
        .embedding_dim(8)
        .learning_rate(0.05)
        .l2_penalty(1e-3)
        .loss(loss)
        .optimizer(kind)
        .num_epochs(2)
        .batch_size(16)
        .packed(packed)
        .sparse_updates(sparse)
        .from_seed(3)
    )
    if family == "attention":
        hp = hp.num_layers(1).num_heads(2).dropout(dropout)
    return hp


def _data():
    return datasets.synthetic_interactions(*DATA[:3], rng=DATA[3]).to_compressed()


# (name, world, mesh, hyperparameters). BPR runs with Adam (the run-sum
# watch item: BPR/Adagrad near the initial weights is ill-conditioned).
CASES = [
    ("lstm-dense-d2", 2, (2, 1), _hyper("lstm", Loss.HINGE, Optimizer.ADAM, False, False)),
    ("attention-dropout-d2", 2, (2, 1), _hyper("attention", Loss.WARP, Optimizer.ADAM, True, False, 0.2)),
    ("ewma-m2", 2, (1, 2), _hyper("ewma", Loss.WARP, Optimizer.ADAGRAD, True, True)),
    ("lstm-warp-d2m2", 4, (2, 2), _hyper("lstm", Loss.WARP, Optimizer.ADAGRAD, True, True)),
    ("gru-bpr-d2m2", 4, (2, 2), _hyper("gru", Loss.BPR, Optimizer.ADAM, False, True)),
]
EXTRA = {  # per world: a case of clone checks and one of sharded row checks
    4: [("clone-d2m2", (2, 2), {"clone": True, "check_rows": True})],
}
# recommend_batch's routes on the ranks' slabs (32 rows; 31 and 30 for the
# ragged catalog), as class constants set on the model: the dense top-k,
# the single pass with subgroups of 8 in groups of 16, the group-only single
# pass, the running merge over chunks of 8 rows, and the wide-seen route
# (SERVE_HISTORIES' widest seen list has 9 ids).
ROUTES = {
    "small": {},
    "submax": {"_SERVE_ITEM_CHUNK": 16, "_SUBGROUP_TARGET": 8},
    "group_only": {"_SERVE_ITEM_CHUNK": 16},
    "merge": {"_SERVE_ITEM_CHUNK": 8, "_MERGE_BUFFER_BYTES": 0},
    "wide_seen": {"_SERVE_ITEM_CHUNK": 16, "_SERVE_MAX_POSTFILTER_SEEN": 2},
}
RECOMMEND = {"k": 5, "routes": ROUTES}
# A catalog the model axis splits unevenly, served on a (2, 2) mesh.
RAGGED = ("serve-ragged-d2m2", 4, (2, 2), _hyper("lstm", Loss.HINGE, Optimizer.ADAGRAD, False, True, num_items=61))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """One group of ranks per world size, each running its cases in turn."""
    out = {}
    for world in sorted({w for _, w, _, _ in CASES}):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        cases = [
            {"name": name, "family": hp.to_dict()["model_type"], "hyper": hp.to_dict(), "mesh": list(mesh),
             "data": DATA, "fit": True, "eval": True, "gather": True, "serve": True,
             "save": str(tmp / name), "recommend": RECOMMEND}
            for name, w, mesh, hp in CASES if w == world
        ]
        base = _hyper("lstm", Loss.WARP, Optimizer.ADAGRAD, True, True).to_dict()
        for name, mesh, flags in EXTRA.get(world, []):
            cases.append({"name": name, "family": "lstm", "hyper": base, "mesh": list(mesh), "data": DATA,
                          "fit": True, **flags})
        name, w, mesh, hp = RAGGED
        if w == world:
            cases.append({"name": name, "family": "lstm", "hyper": hp.to_dict(), "mesh": list(mesh),
                          "gather": True, "recommend": RECOMMEND})
        spec = {"backend": "gloo", "device": "cpu", "timeout_s": 60, "inputs": None,
                "out": str(tmp / "out.npz"), "cases": cases}
        out[world] = launch(world, spec, str(tmp / "spec.json"), GROUP_TIMEOUT_S)
        out[world]["tmp"] = tmp
    return out


def _one_rank(hp):
    model = type(hp).from_dict(hp.to_dict()).build("cpu")
    data = _data()
    model.fit(data)
    return model, data


def test_mesh_shape_rules():
    """The counterpart of ``tests/test_sharding.py:44-48``: the JAX rules."""
    assert mesh_shape(8, 4, 2) == (4, 2)
    assert mesh_shape(8, None, 2) == (4, 2)
    assert mesh_shape(8, 2, None) == (2, 4)
    assert mesh_shape(8) == (8, 1)
    for data, model in ((3, 2), (3, None), (None, 3), (2, 2), (0, None)):
        with pytest.raises(ValueError):
            mesh_shape(8, data, model)


def test_make_mesh_without_a_process_group():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.d, mesh.m) == (1, 1, 0, 0)
    assert mesh.shape == {"data": 1, "model": 1}
    for kw in ({"data": 2}, {"model": 2}, {"ranks": [0, 1]}):
        with pytest.raises(ValueError):
            make_mesh(**kw)


def test_param_specs():
    """The counterpart of ``tests/test_sharding.py:51-60``: the table and
    its optimizer state row-sharded, the tower and the step replicated."""
    model = _hyper("ewma", Loss.HINGE, Optimizer.ADAGRAD, False, True).build("cpu")
    specs = param_specs(model._params)
    assert specs["item_table"] == ("model", None)
    assert specs["tower"]["alpha"] == ()
    state = param_specs(init_opt_state(Optimizer.ADAM, model._params))
    assert state["item_table"] == {"m": ("model", None), "v": ("model", None)}
    assert state["step"] == ()
    assert state["tower"]["alpha"] == {"m": (), "v": ()}


def test_slabs_and_batch_shares():
    class At:  # a rank's coordinates in a (2, 3) mesh
        def __init__(self, d, m):
            self.data, self.model, self.d, self.m = 2, 3, d, m

    assert [slab_range(At(0, m), 64) for m in range(3)] == [(0, 22), (22, 44), (44, 64)]
    tree = {"item_table": torch.arange(64.0)[:, None], "tower": {"alpha": torch.ones(())}}
    slab = shard_model_params(tree, At(1, 2))
    assert torch.equal(slab["item_table"], tree["item_table"][44:]) and slab["tower"]["alpha"] is tree["tower"]["alpha"]
    assert shard_model_params(tree, None) is tree
    assert slab_range(None, 64) == (0, 64)
    with pytest.raises(ValueError):
        slab_range(At(0, 0), 3 * 1 - 1)  # a slab would be empty
    assert [batch_slice(At(d, 0), 16) for d in range(2)] == [slice(0, 8), slice(8, 16)]
    with pytest.raises(ValueError):
        batch_slice(At(0, 0), 15)


def test_num_threads_without_a_process_group_gives_no_mesh():
    hp = _hyper("lstm", Loss.HINGE, Optimizer.ADAGRAD, False, False).num_threads(4)
    model = hp.build("cpu")
    assert model.hyper._mesh is None
    assert np.isfinite(model.fit(_data()))


def test_world_size_one_mesh_is_bit_equal_to_no_mesh():
    hp = _hyper("lstm", Loss.WARP, Optimizer.ADAGRAD, True, True)
    plain, data = _one_rank(hp)
    meshed = type(hp).from_dict(hp.to_dict()).mesh(make_mesh(1, 1)).build("cpu")
    meshed.fit(data)
    np.testing.assert_array_equal(meshed.history.epoch_losses, plain.history.epoch_losses)
    for (path, a), (_, b) in zip(flatten(meshed._params), flatten(plain._params)):
        assert torch.equal(a, b), path
    assert evaluation.mrr_score(meshed, data) == evaluation.mrr_score(plain, data)


def test_clone_keeps_the_mesh():
    """The counterpart of ``tests/test_sharding.py:180-194`` in one process;
    the 4-rank group repeats it on a (2, 2) mesh."""
    mesh = make_mesh(1, 1)
    model = _hyper("lstm", Loss.HINGE, Optimizer.ADAGRAD, False, False).mesh(mesh).build("cpu")
    data = _data()
    model.fit(data)
    twin = model.clone()
    assert twin.hyper._mesh is mesh
    assert twin.fit(data) == model.fit(data)


@pytest.mark.parametrize("name, world, mesh, hp", CASES, ids=[c[0] for c in CASES])
def test_sharded_fit_matches_one_rank(groups, name, world, mesh, hp):
    got = groups[world]["cases"][name]
    arrays = groups[world]["arrays"]
    assert got["mesh"] == list(mesh)
    assert got["replicas_equal"]
    one, data = _one_rank(hp)
    np.testing.assert_allclose(arrays[f"{name}.epoch_losses"], one.history.epoch_losses, rtol=1e-4)
    np.testing.assert_allclose(arrays[f"{name}.params.item_table"], one._params["item_table"].numpy(),
                               rtol=RTOL, atol=ATOL)
    for path, v in flatten(one._params["tower"]):
        np.testing.assert_allclose(arrays[f"{name}.params.tower.{path}"], v.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("name, world, mesh, hp", CASES, ids=[c[0] for c in CASES])
def test_sharded_mrr_matches_one_rank(groups, name, world, mesh, hp):
    """The evaluation of the sharded model (K5 per slab under a model axis)
    gives the ranks of the one-rank evaluation of the same parameters."""
    arrays = groups[world]["arrays"]
    ranks = evaluation._ranks(_loaded(hp, arrays, name), _data())
    np.testing.assert_array_equal(arrays[f"{name}.ranks"], ranks)
    assert groups[world]["cases"][name]["mrr"] == float(np.mean(1.0 / ranks.astype(np.float64)))


def _loaded(hp, arrays, name):
    """A one-rank CPU model holding the sharded run's gathered parameters."""
    model = type(hp).from_dict(hp.to_dict()).build("cpu")
    paths = [p for p, _ in flatten(model._params["tower"])]
    tower = unflatten(paths, [arrays[f"{name}.params.tower.{p}"] for p in paths])
    model.load_numpy_params({"item_table": arrays[f"{name}.params.item_table"], "tower": tower})
    return model


@pytest.mark.parametrize("name, world, mesh, hp", CASES, ids=[c[0] for c in CASES])
def test_sharded_representations_and_predict(groups, name, world, mesh, hp):
    """User representations and ``predict`` of the sharded model (the
    sharded row gather under a model axis) are those of the one-rank model
    holding the same parameters, run on one thread as the ranks run."""
    arrays = groups[world]["arrays"]
    model = _loaded(hp, arrays, name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reps = model.user_representations(SERVE_HISTORIES)
        scores = model.predict(reps[0])
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(arrays[f"{name}.reps"], np.stack([r.user_embedding for r in reps]))
    np.testing.assert_array_equal(arrays[f"{name}.scores"], scores)


def test_model_axis_alone_is_bit_equal_to_one_rank(groups):
    """A (1, 2) mesh splits no sum: the sharded gathers and candidate scores
    are exact and each row's update is the one-rank update, so the fit is
    bit-equal to the one-rank fit run, as the ranks run, on one thread."""
    name, _, _, hp = next(c for c in CASES if c[2] == (1, 2))
    arrays = groups[2]["arrays"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, _ = _one_rank(hp)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(arrays[f"{name}.epoch_losses"], one.history.epoch_losses)
    np.testing.assert_array_equal(arrays[f"{name}.params.item_table"], one._params["item_table"].numpy())
    for path, v in flatten(one._params["tower"]):
        np.testing.assert_array_equal(arrays[f"{name}.params.tower.{path}"], v.numpy(), err_msg=path)


@pytest.mark.parametrize(
    "name, world, mesh, hp", [c for c in CASES if c[2][0] == 2], ids=[c[0] for c in CASES if c[2][0] == 2]
)
def test_data_axis_is_bit_equal_to_two_shares(groups, name, world, mesh, hp):
    """With two data ranks every sum over the data axis is one ``a + b``,
    so a ``(2, m)`` fit is the one-rank fit that runs each batch as two
    shares and sums them (``_data_shares = 2``, no collective), bit for
    bit, on one thread as the ranks run: the data axis's exchange of tower
    gradients, rows and losses, held exactly."""
    arrays = groups[world]["arrays"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = type(hp).from_dict(hp.to_dict()).build("cpu")
        model._data_shares = 2
        model.fit(_data())
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(arrays[f"{name}.epoch_losses"], model.history.epoch_losses)
    np.testing.assert_array_equal(arrays[f"{name}.params.item_table"], model._params["item_table"].numpy())
    for path, v in flatten(model._params["tower"]):
        np.testing.assert_array_equal(arrays[f"{name}.params.tower.{path}"], v.numpy(), err_msg=path)


@pytest.mark.parametrize("lo, hi", [(0, 64), (0, 32), (32, 64), (21, 43), (63, 64)])
def test_a_slab_is_drawn_as_the_whole_table(monkeypatch, lo, hi):
    """A rank draws the table in chunks and keeps its slab: the rows are the
    whole draw's and the generator ends where the whole draw leaves it,
    whatever the chunks' edges; a table of one chunk is drawn as before,
    by one ``normal_`` on the embedding columns."""
    def draw(rows):
        gen = torch.Generator().manual_seed(5)
        table = engine.init_embedding_params(gen, 64, 8, torch.device("cpu"), init_scale=0.5, rows=rows)
        return table["item_table"], gen.get_state()

    whole, state = draw(None)
    old = torch.empty((64, 9))
    old[:, :8].normal_(generator=torch.Generator().manual_seed(5))
    assert torch.equal(whole[:, :8], old[:, :8] * (0.5 / 8)) and not whole[:, 8].any()
    monkeypatch.setattr(engine, "INIT_CHUNK_ROWS", 7)
    chunked, chunked_state = draw(None)
    slab, slab_state = draw((lo, hi))
    assert torch.equal(slab, chunked[lo:hi])
    assert torch.equal(slab_state, chunked_state)


def test_a_load_draws_no_table(monkeypatch, tmp_path):
    """``load_model`` builds the model around the file's table."""
    model = _hyper("lstm", Loss.HINGE, Optimizer.ADAGRAD, False, True).build("cpu")
    model.save(str(tmp_path / "ckpt"))

    def refuse(*args, **kwargs):
        raise AssertionError("a load drew a table")

    monkeypatch.setattr(base, "init_embedding_params", refuse)
    copy = checkpoint.load_model(str(tmp_path / "ckpt"), "cpu")
    for (path, a), (_, b) in zip(flatten(copy._params), flatten(model._params)):
        assert torch.equal(a, b), path


def test_clone_on_a_mesh_and_sharded_rows(groups):
    got = groups[4]["cases"]["clone-d2m2"]
    assert got["clone_fits_alike"]
    assert got["rows_bit_equal"]


@pytest.mark.parametrize("name, world, mesh, hp", CASES, ids=[c[0] for c in CASES])
def test_sharded_save_loads_at_world_size_one(groups, name, world, mesh, hp):
    """Rank 0 writes the whole table (under a model axis, the other slabs
    streamed to it); one process loads it bit for bit."""
    arrays = groups[world]["arrays"]
    model = checkpoint.load_model(str(groups[world]["tmp"] / name), "cpu")
    assert type(model.hyper) is type(hp)
    np.testing.assert_array_equal(model._params["item_table"].numpy(), arrays[f"{name}.params.item_table"])
    for path, v in flatten(model._params["tower"]):
        np.testing.assert_array_equal(v.numpy(), arrays[f"{name}.params.tower.{path}"], err_msg=path)


def test_a_corrupted_checkpoint_raises_on_every_rank(tmp_path):
    """Rank 0 hashes the file; the others read only their slabs, and learn
    of the mismatch from rank 0."""
    model = _hyper("lstm", Loss.HINGE, Optimizer.ADAGRAD, False, True).build("cpu")
    model.save(str(tmp_path / "ckpt"))
    state = tmp_path / "ckpt" / "state.msgpack"
    blob = bytearray(state.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    state.write_bytes(bytes(blob))
    spec = {"backend": "gloo", "device": "cpu", "timeout_s": 60, "inputs": None, "out": str(tmp_path / "out.npz"),
            "cases": [{"name": "corrupt", "load": str(tmp_path / "ckpt"), "mesh": [1, 2]}]}
    with pytest.raises(RuntimeError) as err:
        launch(2, spec, str(tmp_path / "spec.json"), GROUP_TIMEOUT_S)
    failed = str(err.value)
    assert failed.startswith("ranks failed") and failed.count("mismatch") >= 2, failed


SERVED = CASES + [RAGGED]


@pytest.mark.parametrize("name, world, mesh, hp", SERVED, ids=[c[0] for c in SERVED])
def test_sharded_recommend_matches_one_rank(groups, name, world, mesh, hp):
    """``recommend_batch`` on every route (under a model axis: each slab's
    top-k and the cross-shard merge) gives the one-rank model's lists on
    the gathered parameters, run on one thread as the ranks run: scores
    within 1e-5 relative, ids equal except where the scores tie within it."""
    arrays = groups[world]["arrays"]
    model = _loaded(hp, arrays, name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for route, constants in ROUTES.items():
            for key, value in constants.items():
                setattr(model, key, value)
            ids, vals = model.recommend_batch(SERVE_HISTORIES, k=RECOMMEND["k"], return_scores=True)
            for key in constants:
                delattr(model, key)
            got_ids, got_vals = arrays[f"{name}.{route}.ids"], arrays[f"{name}.{route}.vals"]
            np.testing.assert_allclose(got_vals, vals, rtol=1e-5, atol=0, err_msg=route)
            gaps = np.abs(np.diff(vals, axis=1)) <= 1e-5 * np.abs(vals[:, 1:])
            tied = np.zeros(vals.shape, bool)
            tied[:, :-1] |= gaps
            tied[:, 1:] |= gaps
            np.testing.assert_array_equal(got_ids[~tied], np.asarray(ids)[~tied], err_msg=route)
            for h, row in zip(SERVE_HISTORIES, got_ids.tolist()):
                assert len(set(row)) == len(row) and not set(row) & set(h), route
        np.testing.assert_array_equal(arrays[f"{name}.predict"], model.predict(model.user_representation(
            SERVE_HISTORIES[0])))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name, world, mesh, hp", SERVED, ids=[c[0] for c in SERVED])
def test_every_rank_serves_the_same_bits(groups, name, world, mesh, hp):
    """Every rank's ids and scores on every route, and its ``predict``
    scores, hash alike (the ranks of a model group merge the same gathered
    lists; the data replicas hold the same slabs)."""
    got = groups[world]["cases"][name]["recommend"]
    assert len(got["sha256"]) == world and len(set(got["sha256"])) == 1, got["sha256"]
    assert set(got["routes"]) == set(ROUTES)
