"""The shared serving path hands each window's length to the towers that read
it (``_reads_lengths``: HSTU and MLA + MoE) and to no other, and the five
families that served before it keep their bits.

``_parent_representations`` below is ``ImplicitSequenceModel._representations``
as it stood before an untimed tower could read the lengths (HSTU's were
passed beside its times). Every family's ``recommend_batch`` (ids and
scores) and ``user_representations`` are held bit for bit to what they are
with it in its place, on each route of the top-k: the dense small catalog,
the streamed top-k, and wide seen lists served in slabs. Then a model whose
rows are wider than the streamed top-k's score kernel takes is refused when
built, with a catalog past one serving chunk, and only then."""

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch.models import attention, base, ewma, gru, hstu, lstm, mla_moe
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.ops.topk_kernels import MAX_ROW_FLOATS
from sbr_rs_tpu_torch.utils.metrics import span
from sbr_rs_tpu_torch.utils.precision import fp32_matmul

SEQ_LEN, DIM = 8, 8
ROUTES = {
    # name: (num_items, serving chunk, the longest history)
    "small": (300, None, 20),
    "streamed": (3000, 1024, 20),
    "wide_seen": (3000, 1024, 200),
}


def _parent_representations(self, flat, lens, timestamps=None, put=None):
    if self._reads_times and timestamps is None:
        raise ValueError(f"{type(self).__name__} needs the histories' timestamps")
    if not self._reads_times and timestamps is not None:
        raise ValueError(f"{type(self).__name__} reads no timestamps; pass none")
    t = self.hyper._max_sequence_length
    n = self.hyper._num_items
    u = len(lens)
    with span("tower.inputs"):
        window = base._window_ids(flat, lens, t)
        if window.size and (window.min() < 0 or window.max() >= n):
            raise base.InvalidPredictionValue(f"History contains item ids outside [0, {n}).")
        ids, times, last = base._tower_windows(flat, timestamps, lens, t, self.device, put)
    emb = self._rows(ids.reshape(-1))[:, :-1]
    args = (times, last + 1) if self._reads_times else ()
    with fp32_matmul():
        hidden = self._tower_fn()(self._params["tower"], emb.reshape(u, t, -1), *args)
    return hidden[torch.arange(u, device=self.device), last]


def _model(family, n):
    hp = {
        "lstm": lambda: lstm.Hyperparameters(n, SEQ_LEN),
        "ewma": lambda: ewma.Hyperparameters(n, SEQ_LEN),
        "gru": lambda: gru.Hyperparameters(n, SEQ_LEN),
        "attention": lambda: attention.Hyperparameters(n, SEQ_LEN).num_layers(2).num_heads(2),
        "hstu": lambda: hstu.Hyperparameters(n, SEQ_LEN).num_layers(2).num_heads(2),
    }[family]()
    m = hp.embedding_dim(DIM).from_seed(7).build("cpu")
    if family == "ewma":  # a decay that is not the same in every dimension
        m._params["tower"]["alpha"] = torch.linspace(-2.0, 2.0, DIM)
    return m


def _batch(family, n, longest, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 3, SEQ_LEN, SEQ_LEN + 5, longest]
    hist = [rng.integers(0, n, k).tolist() for k in lengths]
    times = [(10**9 + np.cumsum(rng.integers(1, 10**6, k))).tolist() for k in lengths]
    return hist, (times if family == "hstu" else None)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("family", ["lstm", "ewma", "gru", "attention", "hstu"])
def test_the_families_serve_the_parent_paths_bits(family, route, monkeypatch):
    n, chunk, longest = ROUTES[route]
    if chunk is not None:
        monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", chunk)
    m = _model(family, n)
    hist, times = _batch(family, n, longest)
    assert m._catalog_route(n, longest) == route
    calls = []
    tower = m._tower_fn

    def recording():
        fn = tower()

        def run(params, x, *args):
            calls.append(len(args))
            return fn(params, x, *args)

        return run

    monkeypatch.setattr(m, "_tower_fn", recording)
    flat, lens = base._flatten(hist)
    flat_times = None if times is None else base._flatten_times(times, lens)
    got = m.recommend_batch(hist, k=6, return_scores=True, timestamps=times)
    reps = m._representations(flat, lens, flat_times)
    assert calls == [2 if family == "hstu" else 0] * 2  # HSTU: times and lengths; the others: neither
    monkeypatch.setattr(ImplicitSequenceModel, "_representations", _parent_representations)
    want = m.recommend_batch(hist, k=6, return_scores=True, timestamps=times)
    assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
    assert torch.equal(reps, m._representations(flat, lens, flat_times))


def test_the_towers_that_read_lengths_get_them(monkeypatch):
    """An MLA + MoE model's tower is called with each window's length (its
    last position plus one; 1 for an empty history)."""
    m = (mla_moe.Hyperparameters(50, SEQ_LEN).embedding_dim(16)
         .shape(num_hidden_layers=2, num_attention_heads=2, kv_lora_rank=8, qk_nope_head_dim=4, qk_rope_head_dim=4,
                v_head_dim=4, intermediate_size=16, moe_intermediate_size=8, n_routed_experts=4,
                num_experts_per_tok=2, n_shared_experts=1)
         .from_seed(1).build("cpu"))
    seen = []
    tower = m._tower_fn

    def recording():
        fn = tower()

        def run(params, x, lengths):
            seen.append(lengths.tolist())
            return fn(params, x, lengths)

        return run

    monkeypatch.setattr(m, "_tower_fn", recording)
    m.recommend_batch([[], [3], [1, 2, 3], list(range(20))], k=3)
    assert seen == [[1, 1, 3, SEQ_LEN]]


@pytest.mark.parametrize("dim,items,refused", [
    (MAX_ROW_FLOATS, 101, True),  # rows of 513 floats past one chunk
    (MAX_ROW_FLOATS, 100, False),  # one chunk: the dense small route, no score kernel
    (MAX_ROW_FLOATS - 1, 101, False),  # rows of 512 floats: the kernel takes them
])
def test_rows_wider_than_the_score_kernel_takes_are_refused_past_one_chunk(dim, items, refused, monkeypatch):
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 100)
    hp = ewma.Hyperparameters(items, 4).embedding_dim(dim).from_seed(1)
    if not refused:
        assert hp.build("cpu").hyper._item_embedding_dim == dim
        return
    with pytest.raises(ValueError, match=f"wider than the {MAX_ROW_FLOATS} the streamed top-k's score kernel"):
        hp.build("cpu")
