"""Model weights drawn from the run's seed, on the device, by the benchmark's
own generators: the program and the reference get the same bits, and the
reference can draw any part again after the program is gone.

The item table ``[N, D + 1]`` (embedding columns, then the bias) is drawn in
chunks of ``CHUNK_ROWS`` rows, each from a generator seeded by
``(seed, chunk)``, so one chunk can be drawn again alone. A tower is drawn in
one ``normal_`` call and cut into the family's leaves."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from . import spec

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


def tower_leaves(seed: int, cfg: Dict, w: Dict, device) -> Dict[str, torch.Tensor]:
    """The tower's leaves by dotted path, from one draw cut into the
    ``(path, shape, kind, fans)`` that the family's file lists in the port's
    tree layout (``families/<family>.py tower_shapes``): matrices (``w``)
    with the Glorot std of their ``fans``, the position table (``pos``) with
    std ``D ** -0.5``, biases (``b``) with ``tower_bias_std``, layer-norm
    scales (``scale``) ``1 + tower_bias_std * N(0, 1)``."""
    shapes = spec.family_module(cfg["family"]).tower_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _TOWER))
    flat = torch.empty((total,), dtype=torch.float32, device=device).normal_(generator=gen)
    d = int(cfg["embedding_dim"])
    bias_std = float(w["tower_bias_std"])
    out, at = {}, 0
    for path, shape, kind, fans in shapes:
        size = int(np.prod(shape))
        x = flat[at : at + size].reshape(shape).clone()
        at += size
        if kind == "w":
            x.mul_((2.0 / (fans[0] + fans[1])) ** 0.5)
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
