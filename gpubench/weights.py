"""Model weights drawn from the run's seed, on the device, by the benchmark's
own generators: the program and the reference get the same bits, and the
reference can draw any part again after the program is gone.

The item table ``[N, D + 1]`` (embedding columns, then the bias) is drawn in
chunks of ``CHUNK_ROWS`` rows, each from a generator seeded by
``(seed, chunk)``, so one chunk can be drawn again alone. A tower is drawn in
one ``normal_`` call and cut into the family's leaves."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK_ROWS = 1 << 20
_TABLE, _TOWER = 1, 2


def derived_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run ``seed`` (any integer)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def table_chunk(seed: int, index: int, n: int, dim: int, w: Dict, device) -> torch.Tensor:
    """Rows ``[index * CHUNK_ROWS, ...)`` of the f32 table, ``[rows, dim + 1]``."""
    rows = min(CHUNK_ROWS, n - index * CHUNK_ROWS)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _TABLE, index))
    out = torch.empty((rows, dim + 1), dtype=torch.float32, device=device)
    out.normal_(generator=gen)
    out[:, :dim].mul_(float(w["embedding_std"]))
    out[:, dim].mul_(float(w["bias_std"]))
    return out


def chunks(seed: int, n: int, dim: int, w: Dict, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, chunk)`` over the whole table, drawn one at a time."""
    for index in range(-(-n // CHUNK_ROWS)):
        yield index * CHUNK_ROWS, table_chunk(seed, index, n, dim, w, device)


def make_table(seed: int, n: int, dim: int, w: Dict, device, dtype=torch.float32) -> torch.Tensor:
    """The whole table in ``dtype``, chunk by chunk into one allocation."""
    table = torch.empty((n, dim + 1), dtype=dtype, device=device)
    for lo, chunk in chunks(seed, n, dim, w, device):
        table[lo : lo + chunk.shape[0]] = chunk
        del chunk
    return table


def table_rows(seed: int, ids: torch.Tensor, n: int, dim: int, w: Dict, device) -> torch.Tensor:
    """f32 rows of the table at ``ids`` (any order, repeats allowed), drawn
    again chunk by chunk: only the chunks that hold one of them."""
    ids = ids.to(device=device, dtype=torch.int64)
    out = torch.empty((ids.numel(), dim + 1), dtype=torch.float32, device=device)
    which = ids // CHUNK_ROWS
    for index in torch.unique(which).tolist():
        at = torch.nonzero(which == index).flatten()
        chunk = table_chunk(seed, index, n, dim, w, device)
        out[at] = chunk[ids[at] - index * CHUNK_ROWS]
        del chunk
    return out


def tower_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(path, shape, kind)`` of the family's tower leaves in the port's
    tree layout; ``kind`` is ``w`` (a matrix), ``b`` (a bias), ``scale`` (a
    layer norm's scale) or ``pos`` (the position table)."""
    d = int(cfg["embedding_dim"])
    if cfg["family"] == "lstm":
        gates = 3 if cfg["lstm_variant"] == "coupled" else 4
        return [("w_x", (d, gates * d), "w"), ("w_h", (d, gates * d), "w"), ("b", (gates * d,), "b")]
    if cfg["family"] == "attention":
        out = [("pos", (int(cfg["max_sequence_length"]), d), "pos")]
        for i in range(int(cfg["num_layers"])):
            p = f"layers.{i}."
            out += [
                (p + "ln1.scale", (d,), "scale"), (p + "ln1.bias", (d,), "b"),
                (p + "w_qkv", (d, 3 * d), "w"), (p + "w_o", (d, d), "w"),
                (p + "ln2.scale", (d,), "scale"), (p + "ln2.bias", (d,), "b"),
                (p + "w_f1", (d, d), "w"), (p + "b_f1", (d,), "b"),
                (p + "w_f2", (d, d), "w"), (p + "b_f2", (d,), "b"),
            ]
        return out + [("ln_f.scale", (d,), "scale"), ("ln_f.bias", (d,), "b")]
    raise ValueError(f"unknown family {cfg['family']!r}")


def tower_leaves(seed: int, cfg: Dict, w: Dict, device) -> Dict[str, torch.Tensor]:
    """The tower's leaves by dotted path, from one draw: matrices with the
    Glorot std of their fans (per gate for the recurrent families), the
    position table with std ``D ** -0.5``, biases with ``tower_bias_std``,
    layer-norm scales ``1 + tower_bias_std * N(0, 1)``."""
    shapes = tower_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _TOWER))
    flat = torch.empty((total,), dtype=torch.float32, device=device).normal_(generator=gen)
    d = int(cfg["embedding_dim"])
    bias_std = float(w["tower_bias_std"])
    out, at = {}, 0
    for path, shape, kind in shapes:
        size = int(np.prod(shape))
        x = flat[at : at + size].reshape(shape).clone()
        at += size
        if kind == "w":
            fan_out = d if cfg["family"] == "lstm" else shape[1]
            x.mul_((2.0 / (shape[0] + fan_out)) ** 0.5)
        elif kind == "pos":
            x.mul_(d**-0.5)
        elif kind == "b":
            x.mul_(bias_std)
        else:
            x.mul_(bias_std).add_(1.0)
        out[path] = x
    return out


def nest(leaves: Dict[str, torch.Tensor]):
    """Dotted paths to the port's nested tree (dicts; ``layers`` a list)."""
    root: Dict = {}
    for path, v in leaves.items():
        node = root
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def lists(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node

    return lists(root)


def flat_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested tree of tensors (dicts, lists) to its leaves by dotted path."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}{k}."))
    return out
