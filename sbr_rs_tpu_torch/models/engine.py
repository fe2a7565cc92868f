"""Parameter initialisation of the fused item table. Counterpart of
``init_embedding_params`` in :mod:`sbr_rs_tpu.models.engine`; the training
step is not ported yet."""

from __future__ import annotations

from typing import Dict

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def table_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``table_dtype`` hyperparameter."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"table_dtype must be one of {sorted(_DTYPES)}, got {name!r}") from None


def init_embedding_params(
    generator: torch.Generator,
    num_items: int,
    dim: int,
    device: torch.device,
    dtype: str = "float32",
    init_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """The fused item table ``[num_items, dim + 1]`` in the storage dtype:
    embedding columns ``N(0, 1) * init_scale / dim`` (reference
    ``src/models/lstm.rs:22-25``, as the JAX package draws them) and the
    bias as the last column, zero (``src/models/lstm.rs:181``). Drawn in
    place on ``device`` from ``generator``."""
    table = torch.empty((num_items, dim + 1), dtype=table_dtype(dtype), device=device)
    emb = table[:, :dim]
    emb.normal_(generator=generator)
    emb.mul_(init_scale / dim)
    table[:, dim].zero_()
    return {"item_table": table}
