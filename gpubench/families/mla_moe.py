"""DeepSeek-V3's decoder block (Moonlight-16B-A3B's ``config.json`` keys) as
HLLM's user tower (arXiv:2409.12740): RMSNorm, multi-head latent attention
with a decoupled RoPE key, then a SwiGLU MLP (the first
``first_k_dense_replace`` layers) or ``n_routed_experts`` sigmoid-routed
SwiGLU experts, ``num_experts_per_tok`` a token, beside the shared experts.
Its plain tower is ``reference/mla_moe.py``."""

from __future__ import annotations

from typing import Dict

# The block's keys, by the names the configuration file and the port's
# ``MLAMoEShape`` share.
SHAPE_KEYS = (
    "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
    "v_head_dim", "intermediate_size", "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
    "n_shared_experts", "first_k_dense_replace", "routed_scaling_factor", "rope_theta", "rms_norm_eps",
)


def hyperparameters(cfg: Dict):
    from sbr_rs_tpu_torch.models import mla_moe

    if int(cfg["hidden_size"]) != int(cfg["embedding_dim"]):
        raise ValueError(f"hidden_size {cfg['hidden_size']} is not embedding_dim {cfg['embedding_dim']}")
    return mla_moe.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"]).shape(
        **{k: cfg[k] for k in SHAPE_KEYS}
    )


def _sizes(cfg: Dict):
    return (int(cfg["embedding_dim"]), int(cfg["num_attention_heads"]), int(cfg["qk_nope_head_dim"]),
            int(cfg["qk_rope_head_dim"]), int(cfg["kv_lora_rank"]), int(cfg["v_head_dim"]))


def tower_shapes(cfg: Dict):
    """The port's tree, leaf by leaf in its order: matrices with the Glorot
    fans of their own shape (a ``w_gate_up`` per half, an expert's as its
    own matrix), norm gains as scales, the router's correction bias as a
    bias."""
    d, h, n, r, c, v = _sizes(cfg)
    e, f, i = int(cfg["n_routed_experts"]), int(cfg["moe_intermediate_size"]), int(cfg["intermediate_size"])
    shared = int(cfg["n_shared_experts"]) * f

    def swiglu(p, width, lead=()):
        return [(p + "w_down", lead + (width, d), "w", (width, d)),
                (p + "w_gate_up", lead + (d, 2 * width), "w", (d, width))]

    out = [("norm", (d,), "scale", None)]
    for layer in range(int(cfg["num_hidden_layers"])):
        p = f"layers.{layer}."
        out += [
            (p + "attn.kv_norm", (c,), "scale", None),
            (p + "attn.w_kv_a", (d, c + r), "w", (d, c + r)),
            (p + "attn.w_kv_b", (c, h * (n + v)), "w", (c, h * (n + v))),
            (p + "attn.w_o", (h * v, d), "w", (h * v, d)),
            (p + "attn.w_q", (d, h * (n + r)), "w", (d, h * (n + r))),
            (p + "attn_norm", (d,), "scale", None),
            (p + "ffn_norm", (d,), "scale", None),
        ]
        if layer < int(cfg["first_k_dense_replace"]):
            out += swiglu(p + "mlp.", i)
            continue
        out += swiglu(p + "experts.", f, (e,)) + [
            (p + "router", (d, e), "w", (d, e)),
            (p + "router_bias", (e,), "b", None),
        ]
        if shared:
            out += swiglu(p + "shared.", shared)

    def order(entry):
        return [int(s) if s.isdigit() else s for s in entry[0].split(".")]

    return sorted(out, key=order)


def tower_flops(cfg: Dict, positions: float, keys: float) -> float:
    """Per position and layer: the MLA projections ``q``, ``kv_a``, ``kv_b``
    and ``o``; per attended key ``q . k`` and ``A v`` over all heads; then a
    dense layer's SwiGLU (three ``D x intermediate_size`` products), or a MoE
    layer's router, ``num_experts_per_tok`` experts' SwiGLUs and the shared
    experts' one. Norms, RoPE, softmax, SiLU and the routing's sort and
    gathers are not counted."""
    d, h, n, r, c, v = _sizes(cfg)
    layers, dense = int(cfg["num_hidden_layers"]), int(cfg["first_k_dense_replace"])
    moe = max(layers - dense, 0)
    dense = layers - moe
    f = int(cfg["moe_intermediate_size"])
    mla = 2.0 * (d * h * (n + r) + d * (c + r) + c * h * (n + v) + h * v * d)
    per_key = 2.0 * h * (n + r + v)
    mlp = 6.0 * d * int(cfg["intermediate_size"])
    routed = 2.0 * d * int(cfg["n_routed_experts"]) + int(cfg["num_experts_per_tok"]) * 6.0 * d * f
    shared = 6.0 * d * int(cfg["n_shared_experts"]) * f
    return positions * (layers * mla + dense * mlp + moe * (routed + shared)) + layers * per_key * keys
