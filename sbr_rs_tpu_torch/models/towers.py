"""Sequence towers: the encoders mapping input-item embeddings to per-timestep
user states ``[B, T, D]``. Counterpart of :mod:`sbr_rs_tpu.models.towers`.

* LSTM: the fused gate layout of the JAX package: ``w_x`` and ``w_h`` are
  ``[D, G*D]`` and ``b`` is ``[G*D]``, gate order ``[i, f, g, o]`` (Normal)
  or ``[i, g, o]`` (Coupled, forget = 1 - input; reference
  ``src/models/lstm.rs:28-35``). Its recurrence has CUDA kernels
  (:mod:`..ops.lstm_kernels`); :func:`lstm_apply` is the plain loop.
* GRU: gates ``[r, z, n]`` fused the same way, one bias on the x side.
* EWMA: ``u_t = a * u_{t-1} + (1 - a) * x_t``, ``a = sigmoid(alpha)`` per
  dimension (reference ``src/models/ewma.rs:302-313``), as the JAX
  package's two-level blocked affine scan.
* Causal self-attention: pre-LN transformer layers with learned,
  window-relative positions.
* HSTU (Zhai et al. 2024, arXiv:2402.17152): gated pointwise attention
  with no softmax, over a relative bias of positions and bucketed time
  gaps; it reads each position's time as well as its embedding. Its layer
  norms and its attention run CUDA kernels on the card
  (:mod:`..ops.hstu_kernels`).
* MLA + MoE (DeepSeek-V3's decoder block, as Moonlight-16B-A3B publishes
  it): RMSNorm, multi-head latent attention with a decoupled RoPE key, then
  a SwiGLU MLP (the leading dense layers) or a mixture of sigmoid-routed
  SwiGLU experts beside shared ones; HLLM's user tower (arXiv:2409.12740)
  over item embeddings. Plain PyTorch, jagged over each window's length.

The GRU, EWMA and attention towers have no Pallas kernel in the JAX package
and are plain PyTorch here, on every device, keeping the JAX package's
order of arithmetic wherever it sets the rounding. Every tower takes
``starts [B, T]`` (packed batches: 1.0 where a new window begins) and treats
each window as a sequence of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.hstu_kernels import hstu_attention, hstu_gated_norm, hstu_norm
from ..ops.lstm_kernels import lstm_fwd_plain, time_major_inputs
from ..utils.metrics import span
from ..utils.precision import fp32_matmul

Params = Dict[str, torch.Tensor]


def _gated(generator: torch.Generator, dim: int, gates: int, device: torch.device) -> Params:
    """``w_x``, ``w_h`` ``[dim, gates*dim]`` and a zero ``b [gates*dim]``.
    Each gate's ``[dim, dim]`` block is Glorot-normal with per-gate fan, std
    ``sqrt(2 / (dim + dim))``, as in the JAX package."""
    std = (2.0 / (dim + dim)) ** 0.5

    def glorot():
        return std * torch.randn(
            (dim, gates * dim), generator=generator, device=device, dtype=torch.float32
        )

    w_x = glorot()
    w_h = glorot()
    b = torch.zeros((gates * dim,), dtype=torch.float32, device=device)
    return {"w_x": w_x, "w_h": w_h, "b": b}


# -- LSTM ------------------------------------------------------------------------


def init_lstm(generator: torch.Generator, dim: int, coupled: bool, device: torch.device) -> Params:
    """LSTM cell parameters with fused gate matrices (3 gates Coupled, 4
    Normal)."""
    return _gated(generator, dim, 3 if coupled else 4, device)


def lstm_apply(
    params: Params,
    x: torch.Tensor,
    coupled: bool,
    starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the LSTM over ``x [B, T, D]`` returning hidden states
    ``[B, T, D]``, in plain PyTorch on any device: one input projection for
    all timesteps, then a time loop with f32 carries, reset at ``starts``."""
    xz, keep = time_major_inputs(params, x, starts)
    hidden, _ = lstm_fwd_plain(xz, params["w_h"], keep, coupled)
    return hidden.transpose(0, 1)


# -- GRU -------------------------------------------------------------------------


def init_gru(generator: torch.Generator, dim: int, device: torch.device) -> Params:
    """GRU cell parameters, gate order ``[r, z, n]`` (reset, update,
    candidate: the GRU4Rec cell), fused as the LSTM's."""
    return _gated(generator, dim, 3, device)


def gru_apply(params: Params, x: torch.Tensor, starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the GRU over ``x [B, T, D]`` returning hidden states ``[B, T, D]``:
    ``r = sigmoid(x W_xr + b_r + h W_hr)``, ``z`` likewise,
    ``n = tanh(x W_xn + b_n + r * (h W_hn))``, ``h' = (1 - z) * n + z * h``
    with ``h_0 = 0``. The input projection runs once for all timesteps; the
    carry resets at ``starts``. An eager loop over T: a few launches a
    timestep forward, more backward."""
    xz, keep = time_major_inputs(params, x, starts)
    w_h = params["w_h"]
    d = w_h.shape[0]
    h = xz.new_zeros((xz.shape[1], d))
    hidden: List[torch.Tensor] = []
    for t in range(xz.shape[0]):
        if starts is not None:
            h = h * keep[t]
        hz = h @ w_h
        # r and z in one elementwise pass: the same values as two.
        r, z = torch.sigmoid(xz[t, :, : 2 * d] + hz[:, : 2 * d]).split(d, dim=-1)
        n = torch.tanh(xz[t, :, 2 * d :] + r * hz[:, 2 * d :])
        h = (1.0 - z) * n + z * h
        hidden.append(h)
    return torch.stack(hidden, dim=1)


# -- causal self-attention ---------------------------------------------------------


def _glorot(generator: torch.Generator, fan_in: int, fan_out: int, device: torch.device) -> torch.Tensor:
    """``[fan_in, fan_out]`` normal with std ``sqrt(2 / (fan_in + fan_out))``
    (the JAX package's ``_glorot``: fans of the whole matrix)."""
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn((fan_in, fan_out), generator=generator, device=device, dtype=torch.float32)


def init_attention(
    generator: torch.Generator,
    dim: int,
    max_len: int,
    num_layers: int,
    num_heads: int,
    device: torch.device,
) -> Dict:
    """Parameters of the causal self-attention tower: a learned position
    table ``pos [max_len, D]`` (std ``dim ** -0.5``), ``num_layers`` pre-LN
    blocks ``{ln1, w_qkv [D, 3D], w_o, ln2, w_f1, b_f1, w_f2, b_f2}`` and a
    final ``ln_f``; layer norms start at scale 1, bias 0."""
    if dim % num_heads:
        raise ValueError(f"num_heads={num_heads} must divide dim={dim}")
    pos = dim**-0.5 * torch.randn((max_len, dim), generator=generator, device=device, dtype=torch.float32)

    def norm():
        return {
            "scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device),
        }

    def layer():
        return {
            "ln1": norm(),
            "w_qkv": _glorot(generator, dim, 3 * dim, device),
            "w_o": _glorot(generator, dim, dim, device),
            "ln2": norm(),
            "w_f1": _glorot(generator, dim, dim, device),
            "b_f1": torch.zeros((dim,), device=device),
            "w_f2": _glorot(generator, dim, dim, device),
            "b_f2": torch.zeros((dim,), device=device),
        }

    return {"pos": pos, "layers": [layer() for _ in range(num_layers)], "ln_f": norm()}


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * rsqrt(biased var + 1e-6) * scale + bias`` over the last axis."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def dropout_mask(generator: torch.Generator, shape, keep: float, device: torch.device) -> torch.Tensor:
    """A boolean keep mask of ``shape``, each entry True with probability
    ``keep``, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def attention_apply(
    params: Dict,
    x: torch.Tensor,
    num_heads: int,
    dropout: float = 0.0,
    starts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dropout_rows=None,
) -> torch.Tensor:
    """Run the causal transformer encoder over ``x [B, T, D]`` to ``[B, T, D]``.

    Positions are window-relative and attention is block-diagonal across
    packed windows: with ``starts`` marking window beginnings (row position
    0 always begins one), position ``t`` attends only to ``j <= t`` in its
    own window and its position index restarts at each window start,
    clipped to ``max_len - 1``. Masked logits are -1e9, not -inf, as in the
    JAX package. The packed position lookup is a one-hot matmul, exact in
    FP32, so its gradient is a fixed-order sum (an index gather's backward
    would add with atomics on the card).

    ``dropout``/``generator``: inverted dropout on the embedded input and on
    each residual branch (the SASRec placement), drawn from ``generator``
    (:func:`dropout_mask`) only when both ``dropout > 0`` and a generator
    are given; serving and evaluation pass none, so they are deterministic.
    ``dropout_rows = (global_batch, rows)``: ``x`` is the slice ``rows`` of
    a batch of ``global_batch`` rows (a rank's share under a data axis);
    each mask is drawn for the whole batch and sliced, so the ranks draw
    what one rank would.
    """
    b_, t_, d = x.shape
    x = x.to(torch.float32)
    dev = x.device
    pos = params["pos"]
    max_len = pos.shape[0]
    t_idx = torch.arange(t_, device=dev)
    causal = t_idx[None, :] <= t_idx[:, None]  # [T, T]
    if starts is None:
        if t_ <= max_len:
            h = x + pos[:t_][None]
        else:  # beyond the table: the tail positions clamp, as packed rows do
            h = x + pos[t_idx.clamp(max=max_len - 1)][None]
        mask = causal[None, None]  # [1, 1, T, T]
    else:
        s = starts.to(torch.float32).clone()
        s[:, 0] = 1.0  # row position 0 always begins a window
        win_id = torch.cumsum(s, dim=1)  # [B, T]
        start_pos = torch.cummax(torch.where(s > 0, t_idx, 0), dim=1).values
        pos_idx = (t_idx - start_pos).clamp(0, max_len - 1)
        onehot = (pos_idx[..., None] == torch.arange(max_len, device=dev)).to(torch.float32)
        with fp32_matmul():
            h = x + onehot @ pos
        same_win = win_id[:, :, None] == win_id[:, None, :]
        mask = (same_win & causal)[:, None]  # [B, 1, T, T]

    use_dropout = dropout > 0.0 and generator is not None
    keep = 1.0 - dropout

    def drop(v):
        if not use_dropout:
            return v
        if dropout_rows is None:
            mask = dropout_mask(generator, v.shape, keep, dev)
        else:  # the whole batch's mask, this rank's rows of it
            global_batch, rows = dropout_rows
            mask = dropout_mask(generator, (global_batch,) + tuple(v.shape[1:]), keep, dev)[rows]
        return torch.where(mask, v / keep, 0.0)

    h = drop(h)
    hd = d // num_heads
    scale = hd**-0.5
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    for layer in params["layers"]:
        a_in = _layer_norm(layer["ln1"], h)
        qkv = (a_in.reshape(b_ * t_, d) @ layer["w_qkv"]).reshape(b_, t_, 3, num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, hd]
        logits = (q @ k.transpose(-1, -2)) * scale
        attn = torch.softmax(torch.where(mask, logits, neg), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(b_ * t_, d)
        h = h + drop((ctx @ layer["w_o"]).reshape(b_, t_, d))
        f_in = _layer_norm(layer["ln2"], h)
        f = torch.relu(f_in.reshape(b_ * t_, d) @ layer["w_f1"] + layer["b_f1"])
        h = h + drop((f @ layer["w_f2"] + layer["b_f2"]).reshape(b_, t_, d))
    return _layer_norm(params["ln_f"], h)


# -- HSTU ------------------------------------------------------------------------

HSTU_TIME_BUCKETS = 128  # ts_w has HSTU_TIME_BUCKETS + 1 entries
_HSTU_EPS = 1e-6


def init_hstu(
    generator: torch.Generator,
    dim: int,
    max_len: int,
    num_layers: int,
    num_heads: int,
    device: torch.device,
) -> Dict:
    """Parameters of the HSTU tower: a learned position table ``pos
    [max_len, D]`` (std ``dim ** -0.5``) and ``num_layers`` blocks
    ``{w_uvqk [D, 4D], w_o [D, D], b_o [D], pos_w [2 max_len - 1],
    ts_w [129]}``; each head has ``D / num_heads`` columns of U, V, Q and
    K. The relative biases start as the public code's (normal, std 0.02)."""
    if dim % num_heads:
        raise ValueError(f"num_heads={num_heads} must divide dim={dim}")
    pos = dim**-0.5 * torch.randn((max_len, dim), generator=generator, device=device, dtype=torch.float32)

    def layer():
        return {
            "w_uvqk": _glorot(generator, dim, 4 * dim, device),
            "w_o": _glorot(generator, dim, dim, device),
            "b_o": torch.zeros((dim,), device=device),
            "pos_w": 0.02 * torch.randn((2 * max_len - 1,), generator=generator, device=device),
            "ts_w": 0.02 * torch.randn((HSTU_TIME_BUCKETS + 1,), generator=generator, device=device),
        }

    return {"pos": pos, "layers": [layer() for _ in range(num_layers)]}


def hstu_time_buckets(times: torch.Tensor) -> torch.Tensor:
    """``[B, T, T]`` int32 buckets of the time gaps, from ``times [B, T + 1]``
    int64 seconds: ``bucket[i, j] = clamp(trunc(log(float32(max(|g|, 1))) /
    0.301), 0, 128)`` of ``g = times[i + 1] - times[j]``, the public code's
    expression (the query time of position ``i`` is the next column)."""
    gap = times[:, 1:, None] - times[:, None, :-1]
    logs = gap.abs_().clamp_(min=1).to(torch.float32)
    del gap
    return logs.log_().div_(0.301).to(torch.int32).clamp_(0, HSTU_TIME_BUCKETS)


def hstu_apply(
    params: Dict, x: torch.Tensor, times: torch.Tensor, num_heads: int, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Run the HSTU blocks over item embeddings ``x [B, T, D]`` (left-aligned
    windows, padded at the end) with ``times [B, T + 1]`` (int64 seconds: each
    position's time, then the query time of the last position), returning
    each position's output L2-normalised, ``[B, T, D]``.

    ``x_0 = sqrt(D) x + pos[:T]``; per block ``n = LN(x)``, ``U, V, Q, K =
    split(SiLU(n W_uvqk))``, per head ``A = SiLU(Q K^T + rab) / T`` times the
    causal mask (diagonal kept), ``x += (U * LN(concat_h(A V))) W_o + b_o``;
    layer norms without affine, eps 1e-6. ``rab[i, j] = pos_w[max_len - 1 +
    j - i] + ts_w[bucket(times[i + 1] - times[j])]``. On the card each block
    runs three kernels (:mod:`..ops.hstu_kernels`): the pre-norm and the
    gated norm (H1, the gate ``U *`` in its epilogue), and the attention
    (H2), which forms ``A`` in registers and never writes a ``[B, H, T,
    T]`` tensor.

    ``lengths [B]`` (int64, on ``x``'s device): each window's valid
    positions, at most ``T``; ``None``: every position is valid.
    Padding positions only feed outputs past the last valid one; on the card
    the attention skips them, so their rows of ``A V`` are zeros, and the
    valid positions' outputs are the same either way. On the CPU
    ``lengths`` is checked and not read: every position is computed as
    before. ``hstu_apply.positions`` counts the positions computed, padding
    included (the projections run over every position)."""
    with span("hstu.tower"):
        b_, t_, d = x.shape
        pos = params["pos"]
        max_len = pos.shape[0]
        if t_ > max_len:
            raise ValueError(f"a window of {t_} positions is longer than the tower's {max_len}")
        if tuple(times.shape) != (b_, t_ + 1):
            raise ValueError(f"times {tuple(times.shape)} do not match ({b_}, {t_ + 1})")
        hstu_apply.positions += b_ * t_
        hd = d // num_heads
        with span("hstu.bias"):
            buckets = hstu_time_buckets(times)
        h = x.to(torch.float32) * d**0.5 + pos[:t_]
        for layer in params["layers"]:
            uvqk = torch.nn.functional.silu(hstu_norm(h).reshape(b_ * t_, d) @ layer["w_uvqk"])
            u, v, q, k = uvqk.split(d, dim=1)
            v, q, k = (z.reshape(b_, t_, num_heads, hd).transpose(1, 2) for z in (v, q, k))
            with span("hstu.attention"):
                o = hstu_attention(q, k, v, layer["pos_w"], layer["ts_w"], buckets, lengths)  # [B, H, T, hd]
            y = hstu_gated_norm(u, o)
            h = h + (y.reshape(b_ * t_, d) @ layer["w_o"] + layer["b_o"]).reshape(b_, t_, d)
        return h / h.norm(dim=-1, keepdim=True).clamp(min=_HSTU_EPS)


hstu_apply.positions = 0


# -- EWMA ------------------------------------------------------------------------

_EWMA_BLOCK = 16  # the JAX package's k: its block order sets the rounding


def init_ewma(
    generator: torch.Generator, dim: int, device: torch.device, alpha_init: float = 0.0
) -> Params:
    """Per-dimension decay logits, all ``alpha_init`` (0.0: the reference's
    zero init, sigmoid(0) = 0.5; ``src/models/ewma.rs:175-178``). The
    generator goes unused; the signature is the other towers'."""
    del generator
    return {"alpha": torch.full((dim,), float(alpha_init), dtype=torch.float32, device=device)}


def ewma_apply(params: Params, x: torch.Tensor, starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the EWMA recurrence over ``x [B, T, D]``.

    ``u_t = a * u_{t-1} + (1 - a) * x_t`` with ``u_0 = x_0`` is the
    composition of the affine maps ``(A_t, B_t)``: ``(0, x_t)`` at row
    position 0 and at every window start, ``(a, (1 - a) * x_t)`` elsewhere.
    As in the JAX package it runs as a two-level blocked scan over blocks of
    16 timesteps: an inner scan within each block (the padded tail as
    identity maps), a serial exclusive compose over the block totals, and
    one broadcast combine. That order sets the rounding, so it is kept (no
    ``cumprod``/``cumsum``, no loop over T)."""
    a = torch.sigmoid(params["alpha"]).to(x.dtype)  # [D]
    b_, t_, d = x.shape
    one_minus = (1.0 - a) * x
    if starts is None:
        coeff = a.expand(b_, t_ - 1, d)
        shift = one_minus[:, 1:]
    else:
        keep = (1.0 - starts.to(x.dtype))[..., None]  # [B, T, 1]
        coeff = (a * keep)[:, 1:]
        shift = torch.where(keep > 0, one_minus, x)[:, 1:]
    # Row position 0 always begins a window: its map is (0, x_0).
    coeff = torch.cat([coeff.new_zeros((b_, 1, d)), coeff], dim=1)
    shift = torch.cat([x[:, :1], shift], dim=1)

    k = _EWMA_BLOCK
    nb = -(-t_ // k)
    pad = nb * k - t_
    if pad:  # identity maps on the padding tail
        coeff = torch.cat([coeff, coeff.new_ones((b_, pad, d))], dim=1)
        shift = torch.cat([shift, shift.new_zeros((b_, pad, d))], dim=1)
    ab = coeff.reshape(b_, nb, k, d)
    sb = shift.reshape(b_, nb, k, d)

    acc_a, acc_s = ab[:, :, 0], sb[:, :, 0]
    inner_a, inner_s = [acc_a], [acc_s]
    for j in range(1, k):
        acc_a, acc_s = acc_a * ab[:, :, j], sb[:, :, j] + ab[:, :, j] * acc_s
        inner_a.append(acc_a)
        inner_s.append(acc_s)
    inner_a = torch.stack(inner_a, dim=2)  # [B, nb, k, D]
    inner_s = torch.stack(inner_s, dim=2)

    # Exclusive compose of the block totals: the state entering block i.
    pre = [x.new_zeros((b_, d))]
    for i in range(1, nb):
        pre.append(acc_a[:, i - 1] * pre[-1] + acc_s[:, i - 1])
    pre_s = torch.stack(pre, dim=1)  # [B, nb, D]

    u = inner_s + inner_a * pre_s[:, :, None, :]
    return u.reshape(b_, nb * k, d)[:, :t_]


# -- MLA + MoE (DeepSeek-V3's block) -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAMoEShape:
    """The block's sizes, by the names of DeepSeek-V3's ``config.json``;
    the defaults are Moonlight-16B-A3B's published values
    (huggingface.co/moonshotai/Moonlight-16B-A3B, ``config.json``). The
    hidden size is the model's ``embedding_dim``; ``q_lora_rank`` is null
    (``q`` is one projection), and so is ``rope_scaling`` (no YaRN)."""

    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5

    def __post_init__(self):
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            low = 0 if f.name in ("first_k_dense_replace", "n_shared_experts") else 1
            if f.type == "int" and (not isinstance(value, int) or value < low):
                raise ValueError(f"{f.name} must be an integer >= {low}, got {value!r}")
            if f.type == "float":
                if not value > 0:
                    raise ValueError(f"{f.name} must be > 0, got {value!r}")
                object.__setattr__(self, f.name, float(value))  # a config file's 50000 is 50000.0
        if self.qk_rope_head_dim % 2:
            raise ValueError(f"qk_rope_head_dim={self.qk_rope_head_dim} must be even (RoPE rotates pairs)")
        if self.num_experts_per_tok > self.n_routed_experts:
            raise ValueError(
                f"num_experts_per_tok={self.num_experts_per_tok} is more than the "
                f"{self.n_routed_experts} routed experts"
            )


def _swiglu_init(generator: torch.Generator, dim: int, width: int, device: torch.device, experts: int = 0) -> Params:
    """``w_gate_up [D, 2F]`` (the gate's columns, then the up projection's)
    and ``w_down [F, D]``, each half Glorot-normal with fans ``(D, F)``;
    with ``experts``, stacked ``[E, D, 2F]`` and ``[E, F, D]``."""
    lead = (experts,) if experts else ()
    std = (2.0 / (dim + width)) ** 0.5
    return {
        "w_gate_up": std * torch.randn(lead + (dim, 2 * width), generator=generator, device=device),
        "w_down": std * torch.randn(lead + (width, dim), generator=generator, device=device),
    }


def init_mla_moe(generator: torch.Generator, dim: int, shape: MLAMoEShape, device: torch.device) -> Dict:
    """Parameters of the MLA + MoE tower, ``{"layers": [...], "norm"}``: per
    layer ``attn_norm``, ``attn {w_q [D, H (n + r)], w_kv_a [D, c + r],
    kv_norm [c], w_kv_b [c, H (n + v)], w_o [H v, D]}``, ``ffn_norm``, and
    either ``mlp`` (a dense SwiGLU of ``intermediate_size``) or ``router
    [D, E]``, ``router_bias [E]`` (the correction bias), ``experts`` (E
    stacked SwiGLUs of ``moe_intermediate_size``) and ``shared`` (the shared
    experts as one SwiGLU of ``n_shared_experts`` times that width). Matrices
    Glorot-normal, norm gains 1, the correction bias 0."""
    s = shape
    h, n, r, c, v = s.num_attention_heads, s.qk_nope_head_dim, s.qk_rope_head_dim, s.kv_lora_rank, s.v_head_dim

    def layer(index: int) -> Dict:
        out = {
            "attn_norm": torch.ones((dim,), device=device),
            "attn": {
                "w_q": _glorot(generator, dim, h * (n + r), device),
                "w_kv_a": _glorot(generator, dim, c + r, device),
                "kv_norm": torch.ones((c,), device=device),
                "w_kv_b": _glorot(generator, c, h * (n + v), device),
                "w_o": _glorot(generator, h * v, dim, device),
            },
            "ffn_norm": torch.ones((dim,), device=device),
        }
        if index < s.first_k_dense_replace:
            out["mlp"] = _swiglu_init(generator, dim, s.intermediate_size, device)
            return out
        out["router"] = _glorot(generator, dim, s.n_routed_experts, device)
        out["router_bias"] = torch.zeros((s.n_routed_experts,), device=device)
        out["experts"] = _swiglu_init(generator, dim, s.moe_intermediate_size, device, s.n_routed_experts)
        if s.n_shared_experts:
            out["shared"] = _swiglu_init(generator, dim, s.n_shared_experts * s.moe_intermediate_size, device)
        return out

    return {"layers": [layer(i) for i in range(s.num_hidden_layers)], "norm": torch.ones((dim,), device=device)}


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * gain`` over the last axis."""
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * gain


def rope_angles(positions: torch.Tensor, width: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``[M, width / 2]`` of ``positions [M]``: pair ``i``
    turns by ``position * theta ** (-2 i / width)``, in f32 as DeepSeek-V3's
    rotary embedding computes it."""
    inv_freq = 1.0 / theta ** (torch.arange(0, width, 2, device=positions.device, dtype=torch.float32) / width)
    ang = positions.to(torch.float32)[:, None] * inv_freq[None]
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate each pair ``(2i, 2i + 1)`` of ``x [M, ..., width]`` by the
    angles of ``cos``/``sin [M, width / 2]`` (DeepSeek's interleaved layout,
    left interleaved: its de-interleaving permutes ``q`` and ``k`` alike,
    so every score is the same)."""
    lead = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
    cos, sin = cos.reshape(lead), sin.reshape(lead)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).flatten(-2)


def _swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) * (x W_up)) W_down`` of ``x [M, D]``."""
    gate, up = (x @ p["w_gate_up"]).chunk(2, dim=1)
    return (torch.nn.functional.silu(gate) * up) @ p["w_down"]


def _mla(p: Dict, x: torch.Tensor, shape: MLAMoEShape, rows: torch.Tensor, cols: torch.Tensor,
         cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor, b_: int, t_: int) -> torch.Tensor:
    """Multi-head latent attention of the valid positions ``x [M, D]``
    (already normed): ``q = x W_q``; ``[c, k_pe] = x W_kv_a``; ``[k_nope, v]
    = RMSNorm(c) W_kv_b``; RoPE on ``q_pe`` and the one shared ``k_pe``;
    causal softmax attention scaled by ``(n + r) ** -0.5`` in the padded
    ``[B, H, T, T]`` layout (position ``m`` at ``(rows[m], cols[m])``),
    where ``mask [B, 1, T, T]`` keeps each query's valid keys at or before
    it; then ``concat_h(A v) W_o``."""
    s = shape
    m = x.shape[0]
    h, n, r, c, v = s.num_attention_heads, s.qk_nope_head_dim, s.qk_rope_head_dim, s.kv_lora_rank, s.v_head_dim
    q = (x @ p["w_q"]).view(m, h, n + r)
    c_kv, k_pe = (x @ p["w_kv_a"]).split([c, r], dim=1)
    kv = (rms_norm(c_kv, p["kv_norm"], s.rms_norm_eps) @ p["w_kv_b"]).view(m, h, n + v)
    q = torch.cat([q[..., :n], rope(q[..., n:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :n], rope(k_pe, cos, sin)[:, None].expand(m, h, r)], dim=-1)
    qp = x.new_zeros((b_, h, t_, n + r))
    kp = x.new_zeros((b_, h, t_, n + r))
    vp = x.new_zeros((b_, h, t_, v))
    qp[rows, :, cols] = q
    kp[rows, :, cols] = k
    vp[rows, :, cols] = kv[..., n:]
    scores = (qp @ kp.transpose(-1, -2)).mul_((n + r) ** -0.5).masked_fill_(~mask, float("-inf"))
    del qp, kp
    out = torch.softmax(scores, dim=-1) @ vp
    return out[rows, :, cols].reshape(m, h * v) @ p["w_o"]


def moe_route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, k: int,
              scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's sigmoid router with its correction bias (``topk_method
    noaux_tc``, one group): ``s = sigmoid(x W_router)``, the experts ``idx =
    top_k(s + bias)`` (the bias chooses and does not weigh), their weights
    ``s[idx] / (sum s[idx] + 1e-20) * scaling``. ``([M, k], [M, k])``."""
    s = torch.sigmoid(x @ router)
    idx = torch.topk(s + bias, k, dim=1).indices
    w = s.gather(1, idx)
    return idx, w / (w.sum(dim=1, keepdim=True) + 1e-20) * scaling


def _moe(layer: Dict, x: torch.Tensor, shape: MLAMoEShape) -> torch.Tensor:
    """The routed experts and the shared ones over the valid positions ``x
    [M, D]`` (already normed). The token-expert pairs are sorted by expert
    (a stable sort, so each expert reads its tokens in order), each expert
    runs its SwiGLU on its own rows, the results go back to their pairs and
    each token sums its ``k`` weighted outputs in the router's order, then
    the shared experts' output is added."""
    m, d = x.shape
    k = shape.num_experts_per_tok
    experts = layer["experts"]
    with span("moe.route"):
        idx, w = moe_route(x, layer["router"], layer["router_bias"], k, shape.routed_scaling_factor)
        order = torch.argsort(idx.reshape(-1), stable=True)
        counts = torch.bincount(idx.reshape(-1), minlength=shape.n_routed_experts).tolist()
        rows = x.index_select(0, order // k)
    mla_moe_apply.routed_tokens += sum(counts)
    mla_moe_apply.max_expert_tokens += max(counts, default=0)
    with span("moe.experts"):
        out = torch.empty((m * k, d), dtype=x.dtype, device=x.device)
        at = 0
        for e, count in enumerate(counts):
            if count:
                p = {"w_gate_up": experts["w_gate_up"][e], "w_down": experts["w_down"][e]}
                out[at : at + count] = _swiglu(p, rows[at : at + count])
            at += count
        del rows
    with span("moe.route"):
        pairs = torch.empty_like(out).index_copy_(0, order, out)
        del out
        routed = (pairs.view(m, k, d) * w[..., None]).sum(dim=1)
    if "shared" in layer:
        with span("moe.mlp"):
            routed = routed + _swiglu(layer["shared"], x)
    return routed


def mla_moe_apply(params: Dict, x: torch.Tensor, shape: MLAMoEShape,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run DeepSeek-V3's decoder blocks over item embeddings ``x [B, T, D]``
    (left-aligned windows, padded at the end; no position embedding),
    returning ``[B, T, D]``: the final RMSNorm's output at each valid
    position, zeros at the padding.

    Per layer ``h += MLA(RMSNorm(h))`` (:func:`_mla`; RoPE positions
    ``0..L-1`` from each window's oldest item), then ``h += FFN(RMSNorm(h))``:
    a SwiGLU MLP in the first ``first_k_dense_replace`` layers, else
    :func:`_moe`. ``lengths [B]`` (int64, on ``x``'s device; ``None``: every
    position is valid): each window's valid positions, at most ``T``. Only
    those are gathered, so the per-position work (projections, norms, the
    router, the experts, the MLPs) never sees the padding; the attention
    runs in the padded layout, where each query reads only the valid keys at
    or before it, so the padding feeds no valid output.

    Counters: ``mla_moe_apply.positions`` (valid positions computed),
    ``.routed_tokens`` (token-expert pairs computed: ``num_experts_per_tok``
    a position and MoE layer) and ``.max_expert_tokens`` (each MoE layer's
    busiest expert's tokens, summed). Spans ``sbr.moe.tower`` (the call),
    ``sbr.moe.attention`` (each layer's norm and MLA), ``sbr.moe.route``,
    ``sbr.moe.experts`` and ``sbr.moe.mlp`` (the dense and shared
    SwiGLUs). The experts' token counts come to the host once a MoE layer."""
    with span("moe.tower"):
        b_, t_, d = x.shape
        dev = x.device
        col = torch.arange(t_, device=dev)
        if lengths is None:
            lengths = torch.full((b_,), t_, dtype=torch.int64, device=dev)
        valid = col[None] < lengths[:, None]  # [B, T]
        flat = valid.reshape(-1).nonzero().squeeze(1)
        rows, cols = flat // t_, flat % t_
        mask = (valid[:, None, :] & (col[None, :] <= col[:, None])[None])[:, None]  # [B, 1, T, T]
        cos, sin = rope_angles(cols, shape.qk_rope_head_dim, shape.rope_theta)
        h = x.reshape(b_ * t_, d).index_select(0, flat).to(torch.float32)
        mla_moe_apply.positions += flat.numel()
        eps = shape.rms_norm_eps
        for layer in params["layers"]:
            with span("moe.attention"):
                h = h + _mla(layer["attn"], rms_norm(h, layer["attn_norm"], eps), shape, rows, cols, cos, sin,
                             mask, b_, t_)
            if "mlp" in layer:
                with span("moe.mlp"):
                    h = h + _swiglu(layer["mlp"], rms_norm(h, layer["ffn_norm"], eps))
            else:
                h = h + _moe(layer, rms_norm(h, layer["ffn_norm"], eps), shape)
        out = x.new_zeros((b_ * t_, d), dtype=torch.float32)
        out[flat] = rms_norm(h, params["norm"], eps)
        return out.view(b_, t_, d)


mla_moe_apply.positions = 0
mla_moe_apply.routed_tokens = 0
mla_moe_apply.max_expert_tokens = 0
