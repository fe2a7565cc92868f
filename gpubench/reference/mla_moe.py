"""DeepSeek-V3's decoder block as Moonlight-16B-A3B publishes it
(huggingface.co/moonshotai/Moonlight-16B-A3B: ``config.json``,
``modeling_deepseek.py``) as HLLM's user tower (arXiv:2409.12740): a padded
batch of left-aligned windows at a time, every position computed, in the
precision the caller sets (``reference.precision``).

Per window of ``L`` item rows ``x [L, D]`` (no position embedding), layer
``l``: ``h += MLA(RMSNorm(h))``, ``h += FFN_l(RMSNorm(h))``; then the final
RMSNorm, ``RMSNorm(h) = h * rsqrt(mean(h^2) + eps) * g``.

* ``MLA``: ``q = x W_q`` as ``H`` heads of ``n + r`` (``q_lora_rank`` null);
  ``[c, k_pe] = x W_kv_a``; ``[k_nope, v] = RMSNorm(c) W_kv_b``; RoPE of
  base ``rope_theta`` on ``q_pe`` and the one shared ``k_pe``, pair ``(2i,
  2i + 1)`` turned by ``pos * theta ** (-2i / r)`` for positions
  ``0..L-1`` (DeepSeek's interleaved pairs; its de-interleaving permutes
  ``q`` and ``k`` alike and is left out); causal softmax of ``q . k / sqrt(n
  + r)`` (no YaRN, no mscale); ``concat_h(A v) W_o``.
* ``FFN_l``, ``l < first_k_dense_replace``: ``(silu(x W_gate) * (x W_up))
  W_down``.
* Else: ``s = sigmoid(x W_router)``, ``idx = top_k(s + b)`` (the correction
  bias chooses, it does not weigh), ``w = s[idx] / (sum s[idx] + 1e-20) *
  routed_scaling_factor``; ``sum_k w_k SwiGLU_{idx_k}(x)`` plus the shared
  experts as one SwiGLU of ``n_shared_experts * moe_intermediate_size``.
  Here each expert runs on the tokens that chose it, and adds its weighted
  output to theirs, one expert after another.

The representation is the final norm's output at the window's last valid
position. A ``w_gate_up`` holds the gate's columns, then the up
projection's. The departures from the published model are the
configuration's ``assumed``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

F = torch.nn.functional


def _norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * gain


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [..., L, r]`` with each pair turned by its position's angles."""
    length, r = x.shape[-2:]
    inv_freq = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    ang = torch.arange(length, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None]
    cos, sin = ang.cos(), ang.sin()
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1).flatten(-2)


def _swiglu(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    f = w_down.shape[0]
    return (F.silu(x @ w_gate_up[:, :f]) * (x @ w_gate_up[:, f:])) @ w_down


def _attention(cfg: Dict, p: Dict[str, torch.Tensor], w: str, x: torch.Tensor) -> torch.Tensor:
    b, length, _ = x.shape
    h, n, r = int(cfg["num_attention_heads"]), int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    c, v = int(cfg["kv_lora_rank"]), int(cfg["v_head_dim"])
    theta, eps = float(cfg["rope_theta"]), float(cfg["rms_norm_eps"])
    q = (x @ p[w + "w_q"]).view(b, length, h, n + r).transpose(1, 2)
    c_kv, k_pe = (x @ p[w + "w_kv_a"]).split([c, r], dim=-1)
    kv = (_norm(c_kv, p[w + "kv_norm"], eps) @ p[w + "w_kv_b"]).view(b, length, h, n + v).transpose(1, 2)
    q = torch.cat([q[..., :n], _rope(q[..., n:], theta)], dim=-1)
    k = torch.cat([kv[..., :n], _rope(k_pe[:, None], theta).expand(b, h, length, r)], dim=-1)
    scores = q @ k.transpose(-1, -2) / (n + r) ** 0.5
    causal = torch.ones((length, length), dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1, dtype=torch.float32)
    return (a @ kv[..., n:]).transpose(1, 2).reshape(b, length, h * v) @ p[w + "w_o"]


def _moe(cfg: Dict, p: Dict[str, torch.Tensor], w: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [M, D], choice [M, E])`` of tokens ``x [M, D]``."""
    s = torch.sigmoid(x @ p[w + "router"])
    choice = s + p[w + "router_bias"]
    idx = torch.topk(choice, int(cfg["num_experts_per_tok"]), dim=-1).indices
    weight = s.gather(-1, idx)
    weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20) * float(cfg["routed_scaling_factor"])
    out = torch.zeros_like(x)
    for e in range(int(cfg["n_routed_experts"])):
        token, slot = (idx == e).nonzero(as_tuple=True)
        if token.numel():
            y = _swiglu(x[token], p[w + "experts.w_gate_up"][e], p[w + "experts.w_down"][e])
            out.index_add_(0, token, weight[token, slot, None] * y)
    if int(cfg["n_shared_experts"]):
        out = out + _swiglu(x, p[w + "shared.w_gate_up"], p[w + "shared.w_down"])
    return out, choice


def forward(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(out [B, L, D], choices)`` of windows ``x [B, L, D]`` (each row a
    window from its first position), ``choices`` the biased choice scores
    ``s + b`` ``[B, L, E]`` of each MoE layer in order; ``p`` the leaves by
    dotted path."""
    b, length, d = x.shape
    eps = float(cfg["rms_norm_eps"])
    h = x
    choices = []
    for layer in range(int(cfg["num_hidden_layers"])):
        w = f"layers.{layer}."
        h = h + _attention(cfg, p, w + "attn.", _norm(h, p[w + "attn_norm"], eps))
        f = _norm(h, p[w + "ffn_norm"], eps)
        if layer < int(cfg["first_k_dense_replace"]):
            h = h + _swiglu(f, p[w + "mlp.w_gate_up"], p[w + "mlp.w_down"])
        else:
            y, choice = _moe(cfg, p, w, f.reshape(b * length, d))
            h = h + y.view(b, length, d)
            choices.append(choice.view(b, length, -1))
    return _norm(h, p["norm"], eps), choices


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Outputs ``[B, L, D]`` of ``x [B, L, D]``, each row a window."""
    return forward(cfg, p, x)[0]


def representations_and_margins(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories,
                                block_users: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(reps [U, D], margins [U])``: each history's representation (the
    output at the last of its last ``N`` items; an empty history reads as
    item 0) and its routing margin, the least gap between the ``k``-th and
    the ``(k + 1)``-th biased choice score over the tokens that reach the
    representation: every valid position of a MoE layer before the last
    layer, the last position in the last layer (``inf`` where no layer
    routes or ``k`` is every expert). ``rows_fn(ids [M]) -> [M, D + 1]``."""
    n_win, k = int(cfg["max_sequence_length"]), int(cfg["num_experts_per_tok"])
    first_moe, layers = int(cfg["first_k_dense_replace"]), int(cfg["num_hidden_layers"])
    dev = p["norm"].device
    reps, margins = [], []
    for a in range(0, len(histories), block_users):
        block = [list(h[-n_win:]) or [0] for h in histories[a : a + block_users]]
        lens = torch.tensor([len(h) for h in block], device=dev)
        width = int(lens.max())
        ids = torch.zeros((len(block), width), dtype=torch.int64)
        for r, h in enumerate(block):
            ids[r, : len(h)] = torch.tensor(h, dtype=torch.int64)
        x = rows_fn(ids.reshape(-1).to(dev))[:, :-1].reshape(len(block), width, -1)
        out, choices = forward(cfg, p, x)
        last = lens - 1
        users = torch.arange(len(block), device=dev)
        reps.append(out[users, last])
        margin = torch.full((len(block),), float("inf"), device=dev)
        valid = torch.arange(width, device=dev)[None] <= last[:, None]
        for i, choice in enumerate(choices):
            if k >= choice.shape[-1]:
                continue
            top = torch.topk(choice, k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]  # [B, L]
            if first_moe + i == layers - 1:
                gap = gap[users, last]
            else:
                gap = gap.masked_fill(~valid, float("inf")).amin(dim=1)
            margin = torch.minimum(margin, gap)
        margins.append(margin)
    return torch.cat(reps), torch.cat(margins)


def representations(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories) -> torch.Tensor:
    """Each history's representation ``[U, D]`` (:func:`representations_and_margins`)."""
    return representations_and_margins(cfg, p, rows_fn, histories)[0]
