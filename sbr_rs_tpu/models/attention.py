"""Causal self-attention (transformer) implicit-feedback sequence model.

No counterpart in the reference (``src/models/`` has LSTM and EWMA only) —
an EXTENSION of the same ``SequenceModelParameters`` contract
(``src/models/sequence_model.rs:14-25``): the tower is a SASRec-style causal
transformer encoder whose every op is a large batched matrix product, the
shape accelerators run fastest, where the LSTM's ``lax.scan`` serializes
over T. It
plugs into the identical training engine, losses, optimizers, evaluation,
serving and checkpoint machinery as the reference-parity models.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import numpy as np

from . import base
from .towers import attention_apply, init_attention


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitAttentionModel`.

    Defaults: 2 encoder layers, 1 attention head (the SASRec ablation's
    sweet spot for small-embedding recommendation data).
    """

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._num_layers = 2
        self._num_heads = 1
        self._dropout = 0.0

    def dropout(self, rate: float) -> "Hyperparameters":
        """Train-time dropout rate on the embedded input and each residual
        branch (SASRec placement). 0.0 (default) = fully deterministic
        training; serving/eval are always deterministic regardless."""
        if not 0.0 <= rate < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        self._dropout = float(rate)
        return self

    def num_layers(self, num_layers: int) -> "Hyperparameters":
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self._num_layers = int(num_layers)
        return self

    def num_heads(self, num_heads: int) -> "Hyperparameters":
        if num_heads < 1:
            raise ValueError("num_heads must be >= 1")
        self._num_heads = int(num_heads)
        return self

    @classmethod
    def random(
        cls, num_items: int, rng: "np.random.Generator | int | None" = None
    ) -> "Hyperparameters":
        """Random hyperparameters for search (same common ranges as the
        reference's ``Hyperparameters::random()``, ``src/models/lstm.rs:141-172``,
        plus the attention-specific depth/heads)."""
        rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        hp = cls._random_common(num_items, rng)
        hp._num_layers = int(rng.integers(1, 3))
        heads = [h for h in (1, 2, 4) if hp._item_embedding_dim % h == 0]
        hp._num_heads = int(rng.choice(heads))
        hp._dropout = float(rng.choice([0.0, 0.1, 0.2, 0.3, 0.5]))
        return hp

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "attention"
        d["num_layers"] = self._num_layers
        d["num_heads"] = self._num_heads
        d["dropout"] = self._dropout
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._num_layers = d.get("num_layers", 2)
        hp._num_heads = d.get("num_heads", 1)
        hp._dropout = d.get("dropout", 0.0)
        return hp

    def build(self) -> "ImplicitAttentionModel":
        if self._item_embedding_dim % self._num_heads:
            raise ValueError(
                f"num_heads={self._num_heads} must divide "
                f"embedding_dim={self._item_embedding_dim}"
            )
        return ImplicitAttentionModel(self)


class ImplicitAttentionModel(base.ImplicitSequenceModel):
    """Causal-transformer sequence model for implicit feedback.

    Same ``fit`` / ``user_representation`` / ``predict`` / ``recommend``
    surface as the reference-parity models (the ``OnlineRankingModel``
    contract, ``src/lib.rs:101-116``).
    """

    def _rep_fn_cache_key(self):
        # num_heads is baked into the tower closure; num_layers changes the
        # params pytree (jit would re-trace anyway) but keying it keeps the
        # fit-program shape key honest too.
        return (
            type(self).__name__,
            self.hyper._item_embedding_dim,
            self.hyper._num_layers,
            self.hyper._num_heads,
            self.hyper._dropout,
        )

    def _init_tower(self, key: jax.Array, dim: int) -> Dict:
        return init_attention(
            key,
            dim,
            max_len=self.hyper._max_sequence_length,
            num_layers=self.hyper._num_layers,
            num_heads=self.hyper._num_heads,
        )

    def _tower_fn(self):
        # dropout engages only when the caller passes an rng: the training
        # engine does (fold_in from the step key), the serving/eval rep fn
        # does not — so inference through the same partial is deterministic.
        return functools.partial(
            attention_apply,
            num_heads=self.hyper._num_heads,
            dropout=self.hyper._dropout,
        )
