"""sbr-rs-tpu on PyTorch and CUDA: the port of :mod:`sbr_rs_tpu` to NVIDIA
Hopper (H100), beside the JAX package it is held against.

It trains, serves and evaluates the four model families of the JAX package
(:mod:`.models.lstm`, :mod:`.models.ewma`, :mod:`.models.gru` and
:mod:`.models.attention`): ``fit`` (dense table updates for small catalogs,
sparse touched-row updates for large ones, f32 or bf16 tables), user
representations, ``predict``, the exact batched top-k of
``recommend_batch``, and MRR, hit rate and NDCG over the full catalog
(:mod:`.evaluation`). The LSTM recurrence (forward and backward), the
catalog score + group-max, the catalog score + rank count, the row gather,
the row read-modify-write and WARP's candidate score are hand-written CUDA
kernels (``csrc/``), which every family's training, serving and evaluation
run; the EWMA, GRU and attention towers are plain PyTorch, as they have no
kernel in the JAX package. A fifth family, HSTU (:mod:`.models.hstu`),
serves and evaluates on timed histories (``timestamps``); it has no
counterpart in the JAX package and does not train yet. A sixth,
DeepSeek-V3's MLA + MoE block as HLLM's user tower (:mod:`.models.mla_moe`,
Moonlight-16B-A3B's sizes by default), serves and evaluates on plain
histories and does not train either. Models build on the
card (``.build()``) unless the caller asks for the CPU (``.build("cpu")``);
``model.save(dir)`` and ``ImplicitSequenceModel.load(dir)`` write and read
the JAX package's checkpoints (:mod:`.utils.checkpoint`), and
:func:`.utils.metrics.trace` profiles a region. This package imports torch and numpy, never jax, flax
or msgpack.

Example::

    import numpy as np
    import sbr_rs_tpu_torch as sbr
    from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

    data = sbr.datasets.synthetic_interactions(943, 1682, 106, rng=0)
    train, test = sbr.data.user_based_split(data, np.random.default_rng(42), 0.2)
    model = (
        lstm.Hyperparameters(data.num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(4e-4)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .batch_size(256)
        .packed(True)
        .from_seed(42)
        .build()  # the card; build("cpu") runs the plain versions
    )
    loss = model.fit(train.to_compressed())
    ids = model.recommend_batch([[1, 2, 3], [42]], k=10)
    mrr = sbr.evaluation.mrr_score(model, test.to_compressed())
"""

from . import data, datasets, errors, evaluation, models, ops
from .errors import (
    DatasetError,
    FittingError,
    InvalidPredictionValue,
    NoInteractions,
    NonFiniteLoss,
    PredictionError,
)

# Type aliases mirroring the reference (``src/lib.rs:77-81``).
UserId = int
ItemId = int
Timestamp = int

__version__ = "0.1.0"

__all__ = [
    "data",
    "datasets",
    "errors",
    "evaluation",
    "models",
    "ops",
    "UserId",
    "ItemId",
    "Timestamp",
    "__version__",
    "DatasetError",
    "FittingError",
    "InvalidPredictionValue",
    "NoInteractions",
    "NonFiniteLoss",
    "PredictionError",
]
