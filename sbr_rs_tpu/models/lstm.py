"""LSTM-based implicit-feedback sequence model.

Reference: ``src/models/lstm.rs`` — an LSTM over the user's interaction
sequence predicts the next item; Normal and Coupled (forget = 1 - input)
cell variants (``src/models/lstm.rs:28-35``).
"""

from __future__ import annotations

import enum
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from . import base
from .towers import init_lstm, lstm_apply


class LSTMVariant(enum.Enum):
    """Type of LSTM layer to use (reference ``src/models/lstm.rs:28-35``)."""

    NORMAL = "normal"
    COUPLED = "coupled"


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitLSTMModel`
    (reference ``src/models/lstm.rs:38-172``). Default variant: Coupled
    (``src/models/lstm.rs:63``)."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._lstm_variant = LSTMVariant.COUPLED

    def lstm_variant(self, variant: LSTMVariant) -> "Hyperparameters":
        self._lstm_variant = variant
        return self

    @classmethod
    def random(cls, num_items: int, rng: "np.random.Generator | int | None" = None) -> "Hyperparameters":
        """Random hyperparameters for search (reference ``src/models/lstm.rs:141-172``)."""
        rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        hp = cls._random_common(num_items, rng)
        hp._lstm_variant = LSTMVariant.NORMAL if rng.random() < 0.5 else LSTMVariant.COUPLED
        return hp

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["lstm_variant"] = self._lstm_variant.value
        d["model_type"] = "lstm"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._lstm_variant = LSTMVariant(d["lstm_variant"])
        return hp

    def build(self) -> "ImplicitLSTMModel":
        """Build a model out of the chosen hyperparameters
        (reference ``src/models/lstm.rs:197-201``)."""
        return ImplicitLSTMModel(self)


class ImplicitLSTMModel(base.ImplicitSequenceModel):
    """An LSTM-based sequence model for implicit feedback
    (reference ``src/models/lstm.rs:385-416``)."""

    def _rep_fn_cache_key(self):
        # The tower joins the key of every compiled program that runs it.
        return (
            type(self).__name__,
            self.hyper._item_embedding_dim,
            self.hyper._lstm_variant,
            self._pallas_enabled(),
        )

    def _pallas_enabled(self) -> bool:
        """Whether the fused recurrence kernel
        (:mod:`sbr_rs_tpu.ops.pallas_lstm`) is the tower, for training and
        serving alike: on the GPU backend, at the widths where it is the
        faster tower, without a mesh. A mesh runs the ``lax.scan`` tower,
        which XLA partitions on its own."""
        from ..ops.pallas_lstm import kernel_pays

        return (
            self.hyper._mesh is None
            and jax.default_backend() == "gpu"
            and kernel_pays(self.hyper._item_embedding_dim)
        )

    def _init_tower(self, key: jax.Array, dim: int) -> Dict:
        return init_lstm(key, dim, coupled=self.hyper._lstm_variant == LSTMVariant.COUPLED)

    def _tower_fn(self):
        import functools

        coupled = self.hyper._lstm_variant == LSTMVariant.COUPLED
        if self._pallas_enabled():
            from ..ops.pallas_lstm import lstm_apply_pallas

            return functools.partial(lstm_apply_pallas, coupled=coupled)
        return functools.partial(lstm_apply, coupled=coupled)
