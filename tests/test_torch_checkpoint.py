"""The port's checkpoints against the JAX package's, on the CPU.

The codec (``sbr_rs_tpu_torch/utils/msgpack_codec.py``) against flax: the same
tree (numpy arrays, or torch tensors holding the same values) gives the same
bytes, hence the same sha256, as ``flax.serialization.msgpack_serialize``,
whole and chunked (flax's ``MAX_CHUNK_SIZE`` and the codec's both
monkeypatched to 1 KB, pieces of 1000 bytes); the codec's reader returns what
``msgpack_restore`` returns, bit for bit (bf16 as ``torch.bfloat16``).

Checkpoints, per family (N = 60 items, D = 8, T = 8; attention with 2 layers
and 2 heads; random numpy parameters with item biases of spread 1, so no two
scores come near a tie): the JAX package's ``save`` loads in the port and the
port's ``save`` loads in the JAX package (``sbr_rs_tpu.utils.checkpoint``
driven in-process), with parameters bit-equal, ``recommend_batch`` ids
equal and scores within 1e-5, and MRR within 1e-6 relative (the tolerances
of ``tests/test_torch_families.py``). The JAX key survives JAX -> port ->
JAX bit for bit. A port round trip continues ``fit`` bit for bit; a JAX
checkpoint loaded twice continues alike. Mismatched files raise, as
``tests/test_utils.py`` checks for the JAX package.
"""

import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu import evaluation as jax_eval
from sbr_rs_tpu.models import attention as jax_attention
from sbr_rs_tpu.models import ewma as jax_ewma
from sbr_rs_tpu.models import gru as jax_gru
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu.utils import checkpoint as jax_checkpoint
from sbr_rs_tpu_torch import datasets, evaluation
from sbr_rs_tpu_torch.models import attention, ewma, gru, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.utils import checkpoint, msgpack_codec
from sbr_rs_tpu_torch.utils.convert import params_from_numpy
from sbr_rs_tpu_torch.utils.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
NUM_ITEMS, DIM, SEQ_LEN = 60, 8, 8
FAMILIES = {"lstm": (jax_lstm, lstm), "ewma": (jax_ewma, ewma), "gru": (jax_gru, gru),
            "attention": (jax_attention, attention)}
MODEL_CLASSES = {"lstm": lstm.ImplicitLSTMModel, "ewma": ewma.ImplicitEWMAModel, "gru": gru.ImplicitGRUModel,
                 "attention": attention.ImplicitAttentionModel}
SMALL_CHUNK = 1024


def _jax_hyper(name, seed=3, num_items=NUM_ITEMS, dim=DIM, table_dtype="float32"):
    hp = (FAMILIES[name][0].Hyperparameters(num_items, SEQ_LEN).embedding_dim(dim).table_dtype(table_dtype)
          .num_epochs(1).from_seed(seed))
    if name == "lstm":
        hp = hp.lstm_variant(jax_lstm.LSTMVariant.NORMAL)
    if name == "attention":
        hp = hp.num_layers(2).num_heads(2)
    if name == "ewma":
        hp = hp.alpha_init(1.5)
    return hp


def _random_tree(jm, seed):
    """The JAX model's parameter tree, every leaf moved by numpy noise, the
    item biases of spread 1."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jm._params)
    tree = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    tree["item_table"][:, -1] = rng.normal(size=tree["item_table"].shape[0])
    return tree


def _jax_model(name, seed=3, **kw):
    jm = _jax_hyper(name, seed, **kw).build()
    jm._params = jax.tree_util.tree_map(jnp.asarray, _random_tree(jm, seed))
    return jm


def _port_model(name, seed=3, **kw):
    """A port model on the CPU, built from the JAX hyperparameters, with
    random parameters of its own."""
    pm = FAMILIES[name][1].Hyperparameters.from_dict(_jax_hyper(name, seed, **kw).to_dict()).build("cpu")
    jm = _jax_hyper(name, seed + 100, **kw).build()
    pm.load_numpy_params(_random_tree(jm, seed + 100))
    return pm


def _bits(a):
    """An array's or a tensor's bytes, for bit-for-bit comparisons."""
    if isinstance(a, torch.Tensor):
        return a.detach().reshape(-1).view(torch.uint8).numpy().tobytes(), str(a.dtype).split(".")[-1], tuple(a.shape)
    a = np.asarray(a)
    return np.ascontiguousarray(a).tobytes(), a.dtype.name, a.shape


def _assert_params_equal(pm, jm_params):
    """The port model's parameters equal the tree's (JAX arrays, numpy
    arrays or tensors) bit for bit, leaf by leaf in the tree's order."""
    want = jax.tree_util.tree_leaves(jm_params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    got = [pm._params["item_table"]] + [v for _, v in flatten(pm._params["tower"])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


def _assert_same_service(pm, jm):
    rng = np.random.default_rng(5)
    hs = [rng.integers(0, NUM_ITEMS, rng.integers(1, 14)).tolist() for _ in range(24)]
    ids_p, s_p = pm.recommend_batch(hs, k=5, return_scores=True)
    ids_j, s_j = jm.recommend_batch(hs, k=5, return_scores=True)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5, atol=1e-5)
    assert np.asarray(ids_p).tolist() == np.asarray(ids_j).tolist()
    test_p = datasets.synthetic_interactions(30, NUM_ITEMS, 9, rng=2).to_compressed()
    test_j = jax_datasets.synthetic_interactions(30, NUM_ITEMS, 9, rng=2).to_compressed()
    np.testing.assert_allclose(evaluation.mrr_score(pm, test_p), float(jax_eval.mrr_score(jm, test_j)), rtol=1e-6)


# -- the codec against flax ------------------------------------------------------


def _codec_tree(kind):
    """A checkpoint's ``{"key", "params"}`` as the JAX package saves it
    (numpy), at N = 300, D = 32: tables of 39,600 (f32) and 19,800 (bf16)
    bytes, and attention's per-layer leaves of up to 16 KB inside lists."""
    name, dtype = {"lstm f32": ("lstm", "float32"), "lstm bf16": ("lstm", "bfloat16"),
                   "attention": ("attention", "float32")}[kind]
    jm = _jax_model(name, num_items=300, dim=32, table_dtype=dtype)
    return {"key": np.asarray(jm._key), "params": jax.tree_util.tree_map(np.asarray, jm._params)}


def _scalars_tree():
    """Every msgpack width flax writes: ints of each size, str, bin, maps
    and arrays past 16 entries, floats, None, bools, numpy scalars, complex,
    an empty and a 0-d array."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
            -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "ints": ints, "s": "x" * 40, "t": "y" * 300, "u": "z" * 70000, "f": 1.5, "n": None, "yes": True,
        "no": False, "m": {str(i): i for i in range(20)}, "l": list(range(20)), "f32": np.float32(2.5),
        "f64": np.float64(3.5), "i64": np.int64(-7), "b": b"abc" * 100, "bb": b"q" * 70000, "c": 1 + 2j,
        "empty": np.zeros((0, 4), np.float32), "zero_d": np.array(3.0), "bools": np.array([True, False]),
        "big": np.arange(5000, dtype=np.int16),
    }


def _as_torch(tree):
    """The same tree with every array leaf a CPU tensor of the same bits."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return params_from_numpy(tree, "cpu")
    return tree


def _assert_same_tree(got, want, path="state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, torch.Tensor) and _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", SMALL_CHUNK)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", SMALL_CHUNK)
    monkeypatch.setattr(msgpack_codec, "PIECE_BYTES", 1000)
    monkeypatch.setattr(msgpack_codec, "_READ_AHEAD", 7)


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("kind", ["lstm f32", "lstm bf16", "attention", "scalars"])
def test_codec_writes_and_reads_what_flax_does(kind, chunked, leaves, request, tmp_path):
    if chunked:
        request.getfixturevalue("small_chunks")
    tree = _scalars_tree() if kind == "scalars" else _codec_tree(kind)
    want = flax_serialization.msgpack_serialize(tree)
    assert (b"__msgpack_chunked_array__" in want) == chunked
    buf = io.BytesIO()
    digest = msgpack_codec.write(buf, _as_torch(tree) if leaves == "torch" else tree)
    assert buf.getvalue() == want
    assert digest == hashlib.sha256(want).hexdigest()
    (tmp_path / "state.msgpack").write_bytes(want)
    timings = {}
    got, read_digest = msgpack_codec.read(tmp_path / "state.msgpack", timings=timings)
    assert read_digest == digest and set(timings) == {"read_s", "hash_s"}
    _assert_same_tree(got, flax_serialization.msgpack_restore(want))


def test_codec_keeps_lists_whole_as_flax_does(small_chunks):
    """flax never looks into lists for leaves to chunk: attention's layers
    hold leaves past the chunk size, written whole."""
    tree = _codec_tree("attention")
    big = [a for layer in tree["params"]["tower"]["layers"] for a in jax.tree_util.tree_leaves(layer)
           if a.nbytes > SMALL_CHUNK]
    assert big
    buf = io.BytesIO()
    msgpack_codec.write(buf, {"layers": tree["params"]["tower"]["layers"]})
    assert b"__msgpack_chunked_array__" not in buf.getvalue()


def test_codec_rejects_what_flax_cannot_hold(tmp_path):
    with pytest.raises(TypeError):
        msgpack_codec.write(io.BytesIO(), {"t": (1, 2)})
    with pytest.raises(TypeError):
        msgpack_codec.write(io.BytesIO(), {1: 2})
    blob = flax_serialization.msgpack_serialize({"a": np.arange(10, dtype=np.float32)})
    for bad in (blob[:-3], blob + b"\x00"):
        (tmp_path / "bad").write_bytes(bad)
        with pytest.raises(ValueError):
            msgpack_codec.read(tmp_path / "bad")


# -- checkpoints between the packages -------------------------------------------

CASES = [("lstm", "float32"), ("ewma", "float32"), ("gru", "float32"), ("attention", "float32"),
         ("lstm", "bfloat16")]


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name, dtype", CASES)
def test_jax_checkpoint_loads_in_the_port(name, dtype, chunked, request, tmp_path):
    if chunked:
        request.getfixturevalue("small_chunks")
    jm = _jax_model(name, table_dtype=dtype)
    jm.save(str(tmp_path))
    if chunked:
        assert b"__msgpack_chunked_array__" in (tmp_path / "state.msgpack").read_bytes()
    pm = ImplicitSequenceModel.load(str(tmp_path), "cpu")
    assert type(pm) is MODEL_CLASSES[name]
    assert pm.hyper.to_dict() == jm.hyper.to_dict()
    _assert_params_equal(pm, jm._params)
    assert np.array_equal(pm._jax_key, np.asarray(jm._key))
    _assert_same_service(pm, jm)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name, dtype", CASES)
def test_port_checkpoint_loads_in_jax(name, dtype, chunked, request, tmp_path):
    if chunked:
        request.getfixturevalue("small_chunks")
    pm = _port_model(name, table_dtype=dtype)
    pm.save(str(tmp_path))
    blob = (tmp_path / "state.msgpack").read_bytes()
    assert (b"__msgpack_chunked_array__" in blob) == chunked
    jm = jax_checkpoint.load_model(str(tmp_path))
    assert jm.hyper.to_dict()["model_type"] == name
    _assert_params_equal(pm, jm._params)
    assert np.array_equal(np.asarray(jm._key), pm._jax_key)
    _assert_same_service(pm, jm)
    # The bytes the port wrote are the bytes flax writes for the same state.
    state = flax_serialization.msgpack_restore(blob)
    assert flax_serialization.msgpack_serialize(state) == blob


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_key_survives_jax_port_jax(name, tmp_path):
    jm = _jax_model(name)
    jm.save(str(tmp_path / "jax"))
    pm = ImplicitSequenceModel.load(str(tmp_path / "jax"), "cpu")
    pm.clone().save(str(tmp_path / "port"))
    back = jax_checkpoint.load_model(str(tmp_path / "port"))
    assert np.asarray(back._key).dtype == np.uint32
    assert np.array_equal(np.asarray(back._key), np.asarray(jm._key))
    assert not np.array_equal(np.asarray(jm._key), np.asarray(jax.random.PRNGKey(3)))  # a split key
    _assert_params_equal(pm, back._params)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1, 2**32 + 5])
def test_a_fresh_port_model_holds_prngkey_of_its_seed(seed):
    pm = lstm.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).from_seed(seed).build("cpu")
    assert pm._jax_key.dtype == np.uint32
    assert np.array_equal(pm._jax_key, np.asarray(jax.random.PRNGKey(seed)))


def _fit_data():
    return datasets.synthetic_interactions(30, NUM_ITEMS, 9, rng=0).to_compressed()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_round_trip_continues_fit_bit_for_bit(name, tmp_path):
    """Generators restored: the copy's next fit equals the model's."""
    hp = FAMILIES[name][1].Hyperparameters.from_dict(_jax_hyper(name).to_dict())
    if name == "attention":
        hp = hp.dropout(0.2)  # the dropout generator moves too
    model = hp.build("cpu")
    data = _fit_data()
    model.fit(data)
    model.save(str(tmp_path))
    copy = ImplicitSequenceModel.load(str(tmp_path), "cpu")
    _assert_params_equal(copy, model._params)
    for gen in ("_train_generator", "_dropout_generator"):
        assert torch.equal(getattr(copy, gen).get_state(), getattr(model, gen).get_state())
    assert copy.fit(data) == model.fit(data)
    _assert_params_equal(copy, model._params)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_jax_checkpoint_loaded_twice_continues_alike(name, tmp_path):
    """No generator state in a JAX checkpoint: both generators are seeded
    from its key, so two loads continue alike."""
    _jax_model(name).save(str(tmp_path))
    a, b = (ImplicitSequenceModel.load(str(tmp_path), "cpu") for _ in range(2))
    fresh = FAMILIES[name][1].Hyperparameters.from_dict(_jax_hyper(name).to_dict()).build("cpu")
    assert not torch.equal(a._train_generator.get_state(), fresh._train_generator.get_state())
    data = _fit_data()
    assert a.fit(data) == b.fit(data)
    _assert_params_equal(a, b._params)


def test_generators_from_another_device_type_are_seeded_from_the_key(tmp_path):
    """A port checkpoint whose generators ran on another device type (CUDA's
    Philox against the CPU's mt19937) is seeded from its key, as a JAX one."""
    model = _port_model("lstm")
    model.save(str(tmp_path / "cpu"))
    state, _ = msgpack_codec.read(tmp_path / "cpu" / "state.msgpack")
    state["torch"]["device"] = "cuda"
    other = tmp_path / "cuda"
    other.mkdir()
    with open(other / "state.msgpack", "wb") as f:
        digest = msgpack_codec.write(f, state)
    config = json.loads((tmp_path / "cpu" / "config.json").read_text())
    config["state_sha256"] = digest
    (other / "config.json").write_text(json.dumps(config))
    loaded = ImplicitSequenceModel.load(str(other), "cpu")
    seeded = torch.Generator().manual_seed(int(np.random.SeedSequence([0, 3, 0]).generate_state(1, np.uint64)[0]))
    assert torch.equal(loaded._train_generator.get_state(), seeded.get_state())
    assert not torch.equal(loaded._train_generator.get_state(), model._train_generator.get_state())
    _assert_params_equal(loaded, model._params)


# -- errors, as tests/test_utils.py checks them for the JAX package ---------------


def _toy_pair():
    return (datasets.synthetic_interactions(20, 25, 6, rng=0).to_compressed(),
            jax_datasets.synthetic_interactions(20, 25, 6, rng=0).to_compressed())


def _save_ewma(writer, path, lr=0.1):
    port_data, jax_data = _toy_pair()
    if writer == "port":
        model = ewma.Hyperparameters(25, 8).embedding_dim(16).learning_rate(lr).num_epochs(1).from_seed(0).build("cpu")
        model.fit(port_data)
    else:
        model = jax_ewma.Hyperparameters(25, 8).embedding_dim(16).learning_rate(lr).num_epochs(1).from_seed(0).build()
        model.fit(jax_data)
    model.save(str(path))


def _loaders(writer):
    """The port's loader, and for a port-written checkpoint the JAX one."""
    loaders = [lambda p: checkpoint.load_model(p, "cpu")]
    if writer == "port":
        loaders.append(jax_checkpoint.load_model)
    return loaders


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_mismatch_detected(writer, tmp_path):
    """A config/state pair from different saves must fail loudly."""
    path = tmp_path / "ckpt"
    _save_ewma(writer, path)
    cfg = json.loads((path / "config.json").read_text())
    cfg["item_embedding_dim"] = 64
    (path / "config.json").write_text(json.dumps(cfg))
    for load in _loaders(writer):
        with pytest.raises(ValueError, match="mismatch"):
            load(str(path))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_same_shape_stale_config_detected(writer, tmp_path):
    """A stale config whose dims coincide with the new state (changed lr
    only) is rejected by the state's hash."""
    path = tmp_path / "ckpt"
    _save_ewma(writer, path, lr=0.1)
    stale_config = (path / "config.json").read_text()
    _save_ewma(writer, path, lr=0.5)
    (path / "config.json").write_text(stale_config)
    for load in _loaders(writer):
        with pytest.raises(ValueError, match="mismatch"):
            load(str(path))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_corrupted_state_detected(writer, tmp_path):
    path = tmp_path / "ckpt"
    _save_ewma(writer, path)
    blob = bytearray((path / "state.msgpack").read_bytes())
    blob[len(blob) // 2] ^= 0x01
    (path / "state.msgpack").write_bytes(bytes(blob))
    for load in _loaders(writer):
        with pytest.raises(ValueError, match="mismatch"):
            load(str(path))


def test_unknown_model_type_and_no_card(tmp_path, monkeypatch):
    path = tmp_path / "ckpt"
    _save_ewma("port", path)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):  # the card is the default device
            ImplicitSequenceModel.load(str(path))
    cfg = json.loads((path / "config.json").read_text())
    cfg["model_type"] = "rnn"
    (path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="Unknown model_type"):
        ImplicitSequenceModel.load(str(path), "cpu")


def test_checkpoints_need_no_jax_flax_msgpack_or_ml_dtypes(tmp_path):
    """A bf16 model saved and loaded by the port alone, in a process that
    never imports jax, flax, msgpack or ml_dtypes; JAX then reads the same
    table bits."""
    code = (
        "import sys, torch\n"
        "from sbr_rs_tpu_torch.models import lstm\n"
        "from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel\n"
        "m = lstm.Hyperparameters(300, 4).embedding_dim(8).table_dtype('bfloat16').from_seed(1).build('cpu')\n"
        f"m.save({str(tmp_path)!r})\n"
        f"c = ImplicitSequenceModel.load({str(tmp_path)!r}, 'cpu')\n"
        "t, u = c._params['item_table'], m._params['item_table']\n"
        "assert t.dtype == torch.bfloat16 and torch.equal(t.view(torch.int16), u.view(torch.int16))\n"
        "bad = [k for k in ('jax', 'flax', 'msgpack', 'ml_dtypes', 'sbr_rs_tpu') if k in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    jm = jax_checkpoint.load_model(str(tmp_path))
    assert np.asarray(jm._params["item_table"]).dtype == ml_dtypes.bfloat16
    pm = ImplicitSequenceModel.load(str(tmp_path), "cpu")
    _assert_params_equal(pm, jm._params)
