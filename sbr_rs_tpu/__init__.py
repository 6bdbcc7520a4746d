"""sbr-rs-tpu: a sequential recommendation framework in JAX.

Brand-new JAX/XLA/pjit/Pallas implementation with the capabilities of
`maciejkula/sbr-rs` (reference layout documented in SURVEY.md): implicit
-feedback sequence models (LSTM normal/coupled, learnable-EWMA, plus a
causal-transformer extension) trained
with BPR / Hinge / WARP pairwise losses and sparse Adagrad / Adam, with
user-based train/test splitting and full-catalog MRR evaluation.

Example (mirrors the reference's README example, ``src/lib.rs:22-58``)::

    import sbr_rs_tpu as sbr
    import numpy as np

    data = sbr.datasets.download_movielens_100k()
    rng = np.random.default_rng(42)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()

    model = (
        sbr.models.lstm.Hyperparameters(data.num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .lstm_variant(sbr.models.lstm.LSTMVariant.NORMAL)
        .loss(sbr.models.Loss.WARP)
        .optimizer(sbr.models.Optimizer.ADAGRAD)
        .num_epochs(10)
        .from_seed(42)
        .build()
    )
    loss = model.fit(train_mat)
    mrr = sbr.evaluation.mrr_score(model, test_mat)
"""

from . import data, datasets, errors, evaluation, models, parallel
from .errors import (
    DatasetError,
    FittingError,
    InvalidPredictionValue,
    NoInteractions,
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
    "parallel",
    "UserId",
    "ItemId",
    "Timestamp",
    "PredictionError",
    "InvalidPredictionValue",
    "FittingError",
    "NoInteractions",
    "DatasetError",
]
