"""Parameter trees (``sbr_rs_tpu_torch.utils.tree``) on the CPU: flatten and
unflatten round-trip nested dicts and lists, walk leaves in
``jax.tree_util``'s order with dotted paths, carry nested trees through the
numpy conversion (bf16 and f32), and ``clone`` copies nested leaves."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from sbr_rs_tpu.models import towers as jax_towers
from sbr_rs_tpu_torch.models import attention
from sbr_rs_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from sbr_rs_tpu_torch.utils.tree import flatten, map_leaves, unflatten

TREES = [
    {"w_x": 1, "w_h": 2, "b": 3},
    {"pos": 1, "layers": [{"w": 2, "ln": {"scale": 3, "bias": 4}}, {"w": 5, "ln": {"scale": 6, "bias": 7}}],
     "ln_f": {"scale": 8, "bias": 9}},
    {"a": [[1, 2], [3, {"b": 4}]], "c": 5},
    [1, {"x": 2}],
]


@pytest.mark.parametrize("tree", TREES)
def test_flatten_unflatten_round_trip(tree):
    pairs = flatten(tree)
    back = unflatten([p for p, _ in pairs], [v for _, v in pairs])
    assert back == tree
    assert [v for _, v in pairs] == jax.tree_util.tree_leaves(tree)
    assert map_leaves(lambda v: v * 10, tree) == unflatten([p for p, _ in pairs], [v * 10 for _, v in pairs])


def test_paths_and_edges():
    assert flatten({"b": 1, "a": {"y": 2, "x": 3}}) == [("a.x", 3), ("a.y", 2), ("b", 1)]
    assert flatten({"layers": [{"w": 1}, {"w": 2}]}) == [("layers.0.w", 1), ("layers.1.w", 2)]
    assert unflatten([], []) == {}
    assert map_leaves(str, {"item_table": 1, "tower": {}}) == {"item_table": "1", "tower": {}}
    with pytest.raises(ValueError):
        unflatten(["a.0", "a.2"], [1, 2])  # list indices must be 0..n-1
    with pytest.raises(ValueError):
        unflatten(["a"], [1, 2])


def test_leaf_order_matches_jax_on_the_attention_tree():
    tree = jax.tree_util.tree_map(
        np.asarray, jax_towers.init_attention(jax.random.PRNGKey(3), 8, 12, num_layers=2, num_heads=2)
    )
    pairs = flatten(params_from_numpy(tree, "cpu"))
    with_path, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert len(pairs) == len(with_path) == 3 + 2 * 10  # pos, ln_f (2); 10 leaves a layer
    for (path, got), (jpath, want) in zip(pairs, with_path):
        keys = [str(getattr(k, "key", getattr(k, "idx", None))) for k in jpath]
        assert path == ".".join(keys)
        np.testing.assert_array_equal(got.numpy(), want)
    assert pairs[0][0] == "layers.0.b_f1" and pairs[-1][0] == "pos"


@pytest.mark.parametrize("table_dtype", [np.float32, ml_dtypes.bfloat16])
def test_numpy_round_trip_of_a_nested_tree(table_dtype):
    rng = np.random.default_rng(0)
    tree = {
        "item_table": rng.normal(size=(20, 9)).astype(table_dtype),
        "tower": {
            "pos": rng.normal(size=(4, 8)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(8, 8)).astype(ml_dtypes.bfloat16),
                        "ln": {"scale": np.ones(8, np.float32)}} for _ in range(2)],
        },
    }
    params = params_from_numpy(tree, "cpu")
    assert isinstance(params["tower"]["layers"], list)
    assert params["tower"]["layers"][1]["w"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    assert isinstance(back["tower"]["layers"], list)
    for (path, got), (_, want) in zip(flatten(back), flatten(tree)):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_clone_copies_nested_leaves():
    model = attention.Hyperparameters(30, 6).embedding_dim(8).num_layers(2).dropout(0.1).from_seed(2).build("cpu")
    torch.rand(5, generator=model._dropout_generator)  # move the dropout stream off its start
    twin = model.clone()
    pairs, twin_pairs = flatten(model._params["tower"]), flatten(twin._params["tower"])
    assert [p for p, _ in pairs] == [p for p, _ in twin_pairs]
    for (path, v), (_, w) in zip(pairs, twin_pairs):
        assert torch.equal(v, w) and v.data_ptr() != w.data_ptr(), path
    assert torch.equal(twin._dropout_generator.get_state(), model._dropout_generator.get_state())
    twin._params["tower"]["layers"][1]["w_qkv"].zero_()
    twin._params["tower"]["ln_f"]["scale"].zero_()
    assert model._params["tower"]["layers"][1]["w_qkv"].abs().sum() > 0
    assert torch.equal(model._params["tower"]["ln_f"]["scale"], torch.ones(8))
