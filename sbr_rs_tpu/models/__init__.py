"""Models module: shared enums and the user-representation type.

Reference: ``src/models/mod.rs``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class OnlineRankingModel(Protocol):
    """Structural protocol of the reference's core trait
    (``src/lib.rs:101-116``): anything with these two methods can be scored
    by :func:`sbr_rs_tpu.evaluation.mrr_score`."""

    def user_representation(self, item_ids: Sequence[int]) -> "ImplicitUser":
        """Compute a user representation from an interaction history."""
        ...

    def predict(self, user: "ImplicitUser", item_ids: Sequence[int]) -> np.ndarray:
        """Given a user representation, rank ``item_ids`` by score."""
        ...


@dataclasses.dataclass
class ImplicitUser:
    """The user representation used by implicit sequence models
    (reference ``src/models/mod.rs:9-12``)."""

    user_embedding: np.ndarray


class Loss(enum.Enum):
    """The loss used for training the model (reference ``src/models/mod.rs:15-23``).

    Formulas (reference ``src/models/lstm.rs:313-320``):

    * ``BPR`` — ``sigmoid(neg - pos)`` (the reference's exact formula, *not*
      ``-log sigmoid(pos - neg)``).
    * ``Hinge`` — ``relu(1 + neg - pos)``.
    * ``WARP`` — hinge with adaptive negative sampling: up to 5 uniform
      draws, first margin-violator accepted, else the last draw
      (``src/models/sequence_model.rs:47-68``). No rank weighting.
    """

    BPR = "bpr"
    HINGE = "hinge"
    WARP = "warp"


class Optimizer(enum.Enum):
    """Optimizer used to train the model (reference ``src/models/mod.rs:26-32``)."""

    ADAGRAD = "adagrad"
    ADAM = "adam"


class Parallelism(enum.Enum):
    """Type of parallelism used to train the model (reference ``src/models/mod.rs:34-41``).

    The reference distinguishes lock-free Hogwild (``Asynchronous``) from
    synchronized shared-memory threads (``Synchronous``). Here both map to
    synchronous data-parallel SPMD over the device mesh — Hogwild's racy
    shared-memory writes have no analogue on a device mesh (and the
    reference itself accepts degraded MRR under parallelism,
    ``src/models/lstm.rs:490-495``). The enum is kept for API parity; it
    does not change execution.
    """

    ASYNCHRONOUS = "asynchronous"
    SYNCHRONOUS = "synchronous"


from . import attention, ewma, gru, lstm  # noqa: E402  (re-exported submodules)

__all__ = [
    "ImplicitUser",
    "OnlineRankingModel",
    "Loss",
    "Optimizer",
    "Parallelism",
    "attention",
    "ewma",
    "gru",
    "lstm",
]
