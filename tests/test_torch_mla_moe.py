"""The port's MLA + MoE family (``models/mla_moe.py``, ``models/towers.py
mla_moe_apply``) against the plain reference ``tests/mla_moe_reference.py``,
on the CPU at d = 64, 4 heads, ``kv_lora_rank`` 32, nope/rope/v 16/8/16, 8
experts of width 32 with 2 a token, 1 shared, a dense layer of 128, 1 dense
and 2 MoE layers, T = 16, ragged lengths, 64 items.

Tolerance: representations within 2e-5 absolute. They are RMSNorm outputs
of components up to ~4.5; the port computes the valid positions jagged and
the reference the padded window, so their float32 sums run in other orders,
which moves a component by a few 1e-6 (4.5e-6 seen over 20 seeds).
Dropping the correction bias or RoPE moves it by 1e-2 or more at these
weights. A user whose reference routing margin (the k-th less the
(k+1)-th biased choice score at a token that reaches the representation)
is under ``NEAR_TIE`` may take other experts in the port, and is excused,
as the benchmark's check excuses them; these seeds have none.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch import evaluation
from sbr_rs_tpu_torch.data import Interactions
from sbr_rs_tpu_torch.models import base, mla_moe
from sbr_rs_tpu_torch.models.towers import MLAMoEShape, mla_moe_apply, moe_route, rope, rope_angles
from sbr_rs_tpu_torch.utils.tree import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mla_moe_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUM_ITEMS, DIM, SEQ_LEN = 64, 64, 16
SHAPE = dict(num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1)
CFG = dict(SHAPE, max_sequence_length=SEQ_LEN, first_k_dense_replace=1, routed_scaling_factor=2.446,
           rope_theta=50000.0, rms_norm_eps=1e-5)
MOE_LAYERS = 2
ATOL = 2e-5
NEAR_TIE = 1e-4


def _model(seed=3):
    """A model whose norm gains are drawn about 1 (std 0.1), whose
    correction biases are drawn (std 0.1), and whose item biases spread by
    1 (no near ties in the lists)."""
    m = mla_moe.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).shape(**SHAPE).from_seed(seed).build("cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for path, v in flatten(m._params["tower"]):
        if path.endswith("norm"):
            v.copy_(1 + 0.1 * torch.randn(v.shape, generator=g))
        elif path.endswith("router_bias"):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
    m._params["item_table"][:, -1] = torch.randn(NUM_ITEMS, generator=g)
    return m


def _histories(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, NUM_ITEMS, n).tolist() for n in lengths]


def _leaves(model):
    return dict(flatten(model._params["tower"]))


def _reference(model, hist):
    """``(reps, margins)`` of the reference."""
    table = model._params["item_table"]
    return ref.representations_and_margins(CFG, _leaves(model), lambda i: table[i], hist)


def _port(model, hist):
    return torch.from_numpy(np.stack([u.user_embedding for u in model.user_representations(hist)]))


def _assert_close_but_near_ties(got, want, margins, atol=ATOL):
    far = margins >= NEAR_TIE
    assert far.float().mean() >= 0.9, margins
    torch.testing.assert_close(got[far], want[far], rtol=0, atol=atol)


@pytest.mark.parametrize("lengths", [[1, 5, SEQ_LEN, 2 * SEQ_LEN], [0, 3, 9, 16, 17, 40], [SEQ_LEN] * 4])
def test_representations_match_the_reference(lengths):
    m = _model()
    hist = _histories(lengths, seed=len(lengths))
    before = mla_moe_apply.positions
    got = _port(m, hist)
    assert mla_moe_apply.positions - before == sum(max(1, min(n, SEQ_LEN)) for n in lengths)
    want, margins = _reference(m, hist)
    _assert_close_but_near_ties(got, want, margins)
    one = m.user_representation(hist[0]).user_embedding
    np.testing.assert_allclose(one, got[0].numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [3, 8])
def test_recommend_batch_lists_and_scores_are_the_references(seed):
    m = _model(seed)
    hist = _histories([1, 4, 7, SEQ_LEN, 19, 30], seed=seed)
    ids, vals = m.recommend_batch(hist, k=6, return_scores=True)
    reps, margins = _reference(m, hist)
    table = m._params["item_table"]
    scores = reps @ table[:, :-1].T + table[:, -1]
    for r, h in enumerate(hist):
        scores[r, h] = float("-inf")
    want_v, want_i = torch.topk(scores, 6, dim=1)
    far = (margins >= NEAR_TIE).tolist()
    assert [i for i, f in zip(ids, far) if f] == [i for i, f in zip(want_i.tolist(), far) if f]
    np.testing.assert_allclose(vals[far], want_v.numpy()[far], rtol=0, atol=1e-4)
    assert m.recommend(hist[2], k=6) == ids[2]


def test_array_rows_serve_as_lists_do():
    m = _model()
    hist = _histories([0, 3, SEQ_LEN, 2 * SEQ_LEN + 1, 0], seed=31)
    want = m.recommend_batch(hist, k=5, return_scores=True)
    got = m.recommend_batch([np.asarray(h, dtype=np.int64) for h in hist], k=5, return_scores=True)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_the_correction_bias_chooses_and_does_not_weigh():
    """Sigmoid scores ``s = [0.9, 0.8, 0.7, 0.1]`` of one token; the bias
    ``[0, 0, 0.3, 0]`` makes the top 2 experts 2 (1.0) and 0 (0.9) instead
    of 0 and 1, and their weights are ``s`` itself, normalised and scaled:
    ``[0.7, 0.9] / 1.6 * 2.446``."""
    s = torch.tensor([[0.9, 0.8, 0.7, 0.1]])
    logits = torch.log(s / (1 - s))  # x @ router with x = 1 and router = logits
    x, router = torch.ones((1, 1)), logits
    idx, w = moe_route(x, router, torch.zeros(4), 2, 2.446)
    assert idx.tolist() == [[0, 1]]
    torch.testing.assert_close(w, torch.tensor([[0.9, 0.8]]) / 1.7 * 2.446)
    idx, w = moe_route(x, router, torch.tensor([0.0, 0.0, 0.3, 0.0]), 2, 2.446)
    assert idx.tolist() == [[2, 0]]
    torch.testing.assert_close(w, torch.tensor([[0.7, 0.9]]) / 1.6 * 2.446)


def test_a_dropped_correction_bias_fails_the_tolerance():
    m = _model()
    hist = _histories([SEQ_LEN, 9, 30, 4], seed=11)
    want, _ = _reference(m, hist)
    for layer in m._params["tower"]["layers"][1:]:
        layer["router_bias"] = torch.zeros_like(layer["router_bias"])
    assert float((_port(m, hist) - want).abs().max()) > 100 * ATOL


def test_padding_is_never_routed():
    """The tower computes the valid positions only: ``positions`` counts
    them, ``routed_tokens`` is ``k`` a valid position and MoE layer, and the
    valid outputs stay bit-equal whatever the padded rows hold (padding is
    zeros in the output)."""
    m = _model()
    lengths = torch.tensor([1, 5, SEQ_LEN, 9])
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, SEQ_LEN, DIM), generator=g)
    valid = torch.arange(SEQ_LEN)[None] < lengths[:, None]
    noisy = torch.where(valid[..., None], x, 100 * torch.randn(x.shape, generator=g))
    counts = (mla_moe_apply.positions, mla_moe_apply.routed_tokens, mla_moe_apply.max_expert_tokens)
    out = mla_moe_apply(m._params["tower"], x, m.hyper._shape, lengths)
    n = int(lengths.sum())
    assert mla_moe_apply.positions - counts[0] == n
    assert mla_moe_apply.routed_tokens - counts[1] == 2 * n * MOE_LAYERS
    assert n * MOE_LAYERS * 2 / 8 <= mla_moe_apply.max_expert_tokens - counts[2] <= n * MOE_LAYERS
    again = mla_moe_apply(m._params["tower"], noisy, m.hyper._shape, lengths)
    assert torch.equal(out[valid], again[valid])
    assert not out[~valid].any()
    hist = _histories([2, 7, SEQ_LEN + 3], seed=2)
    before = mla_moe_apply.routed_tokens
    m.recommend_batch(hist, k=4)
    assert mla_moe_apply.routed_tokens - before == 2 * (2 + 7 + SEQ_LEN) * MOE_LAYERS


def test_rope_turns_each_pair_by_its_position():
    """Pair ``i`` of a vector at position ``p`` turns by ``p * 50000 **
    (-2 i / 8)``: as complex numbers, a product with ``exp(1j * angle)``.
    DeepSeek's layout (pairs de-interleaved, then ``rotate_half``) gives the
    same score of a query and a key, and a score depends on the two
    positions only through their difference."""
    g = torch.Generator().manual_seed(9)
    q, k = torch.randn((6, 8), generator=g, dtype=torch.float64), torch.randn((6, 8), generator=g, dtype=torch.float64)
    pos = torch.tensor([0, 1, 2, 7, 15, 199])
    cos, sin = rope_angles(pos, 8, 50000.0)
    got = rope(q.float(), cos, sin).double()
    ang = pos[:, None].double() * 50000.0 ** (-torch.arange(0, 8, 2, dtype=torch.float64) / 8)
    want = torch.view_as_real(torch.view_as_complex(q.reshape(6, 4, 2).contiguous()) * torch.exp(1j * ang))
    torch.testing.assert_close(got, want.reshape(6, 8), rtol=0, atol=1e-5)
    assert torch.equal(rope(q.float(), *rope_angles(torch.zeros(6, dtype=torch.long), 8, 50000.0)), q.float())

    def deepseek(x, p):  # modeling_deepseek.py's apply_rotary_pos_emb for one head
        c, s = rope_angles(p, 8, 50000.0)
        c, s = torch.cat([c, c], -1).double(), torch.cat([s, s], -1).double()
        x = x.view(-1, 4, 2).transpose(2, 1).reshape(-1, 8)
        return x * c + torch.cat([-x[:, 4:], x[:, :4]], -1) * s

    ours = (rope(q.float(), cos, sin) * rope(k.float(), cos, sin)).sum(-1).double()
    torch.testing.assert_close(ours, (deepseek(q, pos) * deepseek(k, pos)).sum(-1), rtol=0, atol=1e-5)

    def score(pq, pk):
        at = lambda p: rope_angles(torch.tensor([p]), 8, 50000.0)  # noqa: E731
        return (rope(q[:1].float(), *at(pq)) * rope(k[:1].float(), *at(pk))).sum()

    for pq, pk in ((7, 1), (15, 14), (2, 0)):
        torch.testing.assert_close(score(pq, pk), score(pq + 11, pk + 11), rtol=0, atol=1e-5)


def test_a_dropped_rope_fails_the_tolerance(monkeypatch):
    m = _model()
    hist = _histories([SEQ_LEN, 12, 30], seed=13)
    want, _ = _reference(m, hist)
    from sbr_rs_tpu_torch.models import towers

    monkeypatch.setattr(towers, "rope", lambda x, cos, sin: x)
    assert float((_port(m, hist) - want).abs().max()) > 100 * ATOL


def test_a_users_representation_does_not_depend_on_its_batch():
    m = _model()
    hist = _histories([6, 1, SEQ_LEN, 30, 3], seed=17)
    batch = _port(m, hist)
    for r in range(len(hist)):
        torch.testing.assert_close(_port(m, hist[r : r + 1])[0], batch[r], rtol=0, atol=ATOL)


def test_the_spans_nest_in_the_tower():
    from torch.profiler import ProfilerActivity, profile

    m = _model()
    hist = _histories([3, SEQ_LEN + 2, 1])
    want = m.recommend_batch(hist, k=5, return_scores=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = m.recommend_batch(hist, k=5, return_scores=True)
    assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
    names = [e.name for e in prof.events() if e.name.startswith("sbr.moe.")]
    # route: the router and sort, then the combine, a MoE layer; mlp: the
    # dense layer's MLP and each MoE layer's shared experts.
    assert {n: names.count(n) for n in set(names)} == {
        "sbr.moe.tower": 1, "sbr.moe.attention": 3, "sbr.moe.route": 2 * MOE_LAYERS,
        "sbr.moe.experts": MOE_LAYERS, "sbr.moe.mlp": 1 + MOE_LAYERS,
    }


def test_evaluation_ranks_are_the_references():
    m = _model()
    lengths = [2, 5, 9, 12, 20, 31, 1, 7]
    hist = _histories(lengths, seed=19)
    users = np.repeat(np.arange(len(lengths)), lengths)
    test = Interactions(len(lengths), NUM_ITEMS, users, np.concatenate(hist), np.arange(sum(lengths))).to_compressed()
    ranks = evaluation._ranks(m, test)
    table = m._params["item_table"]
    want = []
    for h in hist:
        if len(h) < 2:
            continue
        rep = _reference(m, [h[:-1]])[0][0]
        scores = (table[:, :-1] @ rep + table[:, -1]).numpy()
        scores[h[:-1]] = np.finfo(np.float32).min
        want.append(int((scores >= scores[h[-1]]).sum()))
    assert ranks.tolist() == want
    assert evaluation.mrr_score(m, test) == pytest.approx(np.mean(1.0 / np.array(want)), rel=1e-12)


def test_checkpoint_dict_and_clone_round_trip(tmp_path):
    m = _model()
    hp = mla_moe.Hyperparameters.from_dict(m.hyper.to_dict())
    assert hp.to_dict() == m.hyper.to_dict() and hp.to_dict()["model_type"] == "mla_moe"
    assert hp._shape == MLAMoEShape(**{k: v for k, v in CFG.items() if k != "max_sequence_length"})
    m.save(str(tmp_path / "ckpt"))
    back = base.ImplicitSequenceModel.load(str(tmp_path / "ckpt"), "cpu")
    copy = m.clone()
    hist = _histories([4, SEQ_LEN, 17], seed=23)
    want = m.recommend_batch(hist, k=5, return_scores=True)
    for other in (back, copy):
        assert type(other) is mla_moe.ImplicitMLAMoEModel and other.hyper.to_dict() == m.hyper.to_dict()
        for (pa, a), (pb, b) in zip(flatten(other._params["tower"]), flatten(m._params["tower"])):
            assert pa == pb and torch.equal(a, b)
        got = other.recommend_batch(hist, k=5, return_scores=True)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    copy._params["tower"]["norm"].add_(1.0)
    assert not torch.equal(copy._params["tower"]["norm"], m._params["tower"]["norm"])


def test_the_defaults_are_moonlights_published_sizes():
    """``config.json`` of moonshotai/Moonlight-16B-A3B, as the benchmark's
    configuration file copies it (its depth cut to 5 there)."""
    import json

    published = json.loads((ROOT / "gpubench/configs/moonlight-a3b-ml20m.json").read_text())
    shape = mla_moe.Hyperparameters(10, 5)._shape
    for key, value in vars(shape).items():
        assert value == (27 if key == "num_hidden_layers" else published[key]), key
    assert published["num_hidden_layers"] == 5 and published["reduced"] == ["num_hidden_layers"]


def test_sizes_are_checked():
    hp = mla_moe.Hyperparameters(NUM_ITEMS, SEQ_LEN)
    with pytest.raises(ValueError, match="unknown MLA"):
        hp.shape(num_layers=3)
    with pytest.raises(ValueError, match="must be even"):
        hp.shape(qk_rope_head_dim=7)
    with pytest.raises(ValueError, match="more than the 8 routed experts"):
        hp.shape(n_routed_experts=8, num_experts_per_tok=9)
    with pytest.raises(ValueError, match="num_attention_heads must be an integer >= 1"):
        hp.shape(num_attention_heads=0)


def test_fit_is_not_supported():
    data = Interactions(2, NUM_ITEMS, np.array([0, 0, 0, 1, 1, 1]), np.array([1, 2, 3, 4, 5, 6]),
                        np.arange(6)).to_compressed()
    with pytest.raises(NotImplementedError, match="cannot be fitted"):
        _model().fit(data)


def test_the_two_references_agree_bit_for_bit():
    """``tests/mla_moe_reference.py`` and the benchmark's copy
    ``gpubench/reference/mla_moe.py`` compute the same bits."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_mla_moe_reference", ROOT / "gpubench/reference/mla_moe.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    m = _model()
    leaves = _leaves(m)
    x = torch.randn((3, SEQ_LEN, DIM), generator=torch.Generator().manual_seed(29))
    mine, theirs = ref.forward(CFG, leaves, x), bench.forward(CFG, leaves, x)
    assert torch.equal(mine[0], theirs[0]) and all(torch.equal(a, b) for a, b in zip(mine[1], theirs[1]))
