"""Shared hyperparameter builder and the implicit sequence-model base class.

Mirrors the reference's fluent ``Hyperparameters`` builders
(``src/models/lstm.rs:38-172``, ``src/models/ewma.rs:44-165``) and the
``OnlineRankingModel`` trait (``src/lib.rs:101-116``), re-designed around a
batched, fully-jitted training loop:

* ``fit`` extracts first-chunk-smallest windows (> 2 items), pads them to
  ``[N, T]``, and runs *whole epochs* as one compiled ``lax.scan`` over
  shuffled minibatches — one device program per epoch instead of one
  optimizer step per Python call.
* No subsequences are silently dropped (the reference's thread-partitioning
  drops up to ``num_threads - 1`` chunks when the split is uneven,
  ``src/models/sequence_model.rs:91-98`` — a bug we do not reproduce);
  ragged tails are padded with zero-mask rows instead.
* ``num_threads``/``parallelism`` are accepted for API parity; actual
  parallelism is data-parallel SPMD over a ``jax.sharding.Mesh`` (see
  :mod:`sbr_rs_tpu.parallel`), enabled with :meth:`Hyperparameters.mesh`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data import (
    CompressedInteractions,
    extract_padded_windows,
    pack_streams,
    to_streams,
)
from ..errors import FittingError, InvalidPredictionValue, NoInteractions, NonFiniteLoss
from ..ops.scoring import SCORE_PRECISION, score_rows
from ..utils.metrics import FitHistory, logger
from . import ImplicitUser, Loss, Optimizer, Parallelism
from .engine import EngineConfig, init_embedding_params, init_opt_state, make_train_step


class Hyperparameters:
    """Fluent hyperparameter builder (reference ``src/models/lstm.rs:54-139``).

    Defaults match the reference (``src/models/lstm.rs:56-71``): dim=16,
    lr=0.01, l2=0, loss=BPR, optimizer=Adam, synchronous, 10 epochs.
    ``batch_size`` is new — the reference steps per sequence (minibatch of
    1, ``src/models/sequence_model.rs:163-169``); batched synchronous
    training is the deliberate batched deviation (SURVEY.md §7).
    """

    def __init__(self, num_items: int, max_sequence_length: int):
        self._num_items = int(num_items)
        self._max_sequence_length = int(max_sequence_length)
        self._item_embedding_dim = 16
        self._learning_rate = 0.01
        self._l2_penalty = 0.0
        self._loss = Loss.BPR
        self._optimizer = Optimizer.ADAM
        self._parallelism = Parallelism.SYNCHRONOUS
        self._num_threads = 1
        self._num_epochs = 10
        self._batch_size = 32
        self._seed = int(np.random.SeedSequence().entropy % (2**31))
        self._mesh: Optional[jax.sharding.Mesh] = None
        self._sparse_updates: Optional[bool] = None  # None = auto by table size
        self._packed = False
        self._table_dtype = "float32"
        self._lr_schedule = "constant"
        self._embedding_init_scale = 1.0

    # -- fluent setters (names mirror the reference) -----------------------

    def learning_rate(self, learning_rate: float) -> "Hyperparameters":
        self._learning_rate = float(learning_rate)
        return self

    def lr_schedule(self, schedule: str) -> "Hyperparameters":
        """Learning-rate schedule over the whole fit: ``"constant"``
        (default — the reference's behavior), ``"linear"`` (decay to 0),
        ``"cosine"``, or ``"warmup_cosine"`` (linear warmup over the first
        10% of steps, then cosine decay). Batched synchronous training
        takes far fewer optimizer steps than the reference's per-sequence
        SGD; a decaying tail reduces final-iterate variance (SURVEY.md §7
        hard part 2)."""
        if schedule not in ("constant", "linear", "cosine", "warmup_cosine"):
            raise ValueError(f"unknown lr schedule: {schedule!r}")
        self._lr_schedule = schedule
        return self

    def embedding_init_scale(self, scale: float) -> "Hyperparameters":
        """Multiplier on the embedding init std (default 1.0 = the
        reference's N(0, 1/dim), ``src/models/lstm.rs:22-25``). A tuning
        lever only; 1.0 reproduces the reference bit-for-bit."""
        self._embedding_init_scale = float(scale)
        return self

    def l2_penalty(self, l2_penalty: float) -> "Hyperparameters":
        self._l2_penalty = float(l2_penalty)
        return self

    def embedding_dim(self, embedding_dim: int) -> "Hyperparameters":
        self._item_embedding_dim = int(embedding_dim)
        return self

    def num_epochs(self, num_epochs: int) -> "Hyperparameters":
        self._num_epochs = int(num_epochs)
        return self

    def loss(self, loss: Loss) -> "Hyperparameters":
        self._loss = loss
        return self

    def optimizer(self, optimizer: Optimizer) -> "Hyperparameters":
        self._optimizer = optimizer
        return self

    def parallelism(self, parallelism: Parallelism) -> "Hyperparameters":
        self._parallelism = parallelism
        return self

    def num_threads(self, num_threads: int) -> "Hyperparameters":
        self._num_threads = int(num_threads)
        return self

    def batch_size(self, batch_size: int) -> "Hyperparameters":
        self._batch_size = int(batch_size)
        return self

    def from_seed(self, seed: int) -> "Hyperparameters":
        self._seed = int(seed) % (2**31)
        return self

    def rng(self, rng: "np.random.Generator | int") -> "Hyperparameters":
        """Seed from an RNG or integer (reference ``src/models/lstm.rs:122-125``)."""
        if isinstance(rng, np.random.Generator):
            self._seed = int(rng.integers(0, 2**31))
        else:
            self._seed = int(rng) % (2**31)
        return self

    def mesh(self, mesh: Optional[jax.sharding.Mesh]) -> "Hyperparameters":
        """Train over a device mesh with axes ``("data", "model")``: batches
        sharded over ``data``, the item table/biases row-sharded over
        ``model``. New capability — the reference has no device parallelism."""
        self._mesh = mesh
        return self

    def sparse_updates(self, enabled: Optional[bool]) -> "Hyperparameters":
        """Force the item-table update strategy: True = sort+segment sparse
        path (O(batch) HBM traffic, required for huge catalogs), False =
        dense scatter-add path (faster for small tables), None = auto."""
        self._sparse_updates = enabled
        return self

    def table_dtype(self, dtype: str) -> "Hyperparameters":
        """Storage dtype of the item table and its optimizer state:
        ``"float32"`` (default) or ``"bfloat16"`` (halves the table's device
        memory, for the largest catalogs). All score/gradient math stays
        float32; only
        storage and the final update application round to bf16, so expect a
        small quality cost (the Adagrad accumulator also rounds). New
        capability — the reference is f32-only."""
        self._table_dtype = str(dtype)
        return self

    def packed(self, enabled: bool) -> "Hyperparameters":
        """Pack several variable-length windows into each ``[T]`` row with
        recurrence resets at window starts (:func:`sbr_rs_tpu.data.
        pack_windows`) — mathematically identical losses with fewer padded
        rows. Changes batch composition, so retune lr/batch if
        chasing exact MRR numbers."""
        self._packed = bool(enabled)
        return self

    # -- random search (reference ``src/models/lstm.rs:141-172``) ----------

    @classmethod
    def _random_common(cls, num_items: int, rng: np.random.Generator) -> "Hyperparameters":
        hp = cls(num_items, 2 ** int(rng.integers(4, 8)))
        hp._item_embedding_dim = 2 ** int(rng.integers(4, 8))
        hp._learning_rate = float(10.0 ** rng.uniform(-3.0, 0.5))
        hp._l2_penalty = float(10.0 ** rng.uniform(-7.0, -3.0))
        hp._loss = Loss.BPR if rng.random() < 0.5 else Loss.HINGE
        hp._optimizer = Optimizer.ADAM if rng.random() < 0.5 else Optimizer.ADAGRAD
        # The reference also coin-flips `parallelism`
        # (src/models/lstm.rs:167) — here that knob is a documented no-op
        # (Hogwild has no analogue on a device mesh, models/__init__.py),
        # so the search does NOT sample it: a dead knob is a wasted search
        # dimension and a pure noise column in the results artifact.
        # num_threads (the reference's 1..=num_cpus
        # draw, src/models/lstm.rs:169) is the data-parallel degree here,
        # realized as a (data=n) mesh over the first n devices — sampled
        # over the realizable range only (collapses to the constant 1 on
        # a single chip).
        hp._num_threads = int(rng.integers(1, max(1, jax.device_count()) + 1))
        hp._num_epochs = 2 ** int(rng.integers(3, 7))
        hp._batch_size = int(2 ** rng.integers(3, 8))
        hp._packed = bool(rng.random() < 0.5)
        hp._seed = int(rng.integers(0, 2**31))
        return hp

    def to_dict(self) -> dict:
        return {
            "num_items": self._num_items,
            "max_sequence_length": self._max_sequence_length,
            "item_embedding_dim": self._item_embedding_dim,
            "learning_rate": self._learning_rate,
            "l2_penalty": self._l2_penalty,
            "loss": self._loss.value,
            "optimizer": self._optimizer.value,
            "parallelism": self._parallelism.value,
            "num_threads": self._num_threads,
            "num_epochs": self._num_epochs,
            "batch_size": self._batch_size,
            "seed": self._seed,
            "packed": self._packed,
            "table_dtype": self._table_dtype,
            "sparse_updates": self._sparse_updates,
            "lr_schedule": self._lr_schedule,
            "embedding_init_scale": self._embedding_init_scale,
        }

    @classmethod
    def _from_dict_common(cls, d: dict) -> "Hyperparameters":
        hp = cls(d["num_items"], d["max_sequence_length"])
        hp._item_embedding_dim = d["item_embedding_dim"]
        hp._learning_rate = d["learning_rate"]
        hp._l2_penalty = d["l2_penalty"]
        hp._loss = Loss(d["loss"])
        hp._optimizer = Optimizer(d["optimizer"])
        hp._parallelism = Parallelism(d["parallelism"])
        hp._num_threads = d["num_threads"]
        hp._num_epochs = d["num_epochs"]
        hp._batch_size = d["batch_size"]
        hp._seed = d["seed"]
        hp._packed = d.get("packed", False)
        hp._table_dtype = d.get("table_dtype", "float32")
        hp._sparse_updates = d.get("sparse_updates")
        hp._lr_schedule = d.get("lr_schedule", "constant")
        hp._embedding_init_scale = d.get("embedding_init_scale", 1.0)
        return hp


class _LruCache:
    """Bounded mapping for compiled-program caches: a long hyperopt run over
    random shapes would otherwise accumulate compiled programs without
    eviction. Eviction drops our reference; XLA frees
    the executable when the last jitted-callable reference dies."""

    def __init__(self, maxsize: int):
        import collections

        self._maxsize = maxsize
        self._d = collections.OrderedDict()

    def get(self, key):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return None

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self._maxsize:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


# Module-level jit: compiled once per shape process-wide (per-instance jits
# would recompile the scorer for every hyperopt trial).
def _replicated_put(mesh, arr):
    """Host array -> device array consumable by a jit over ``mesh``.

    Single-process meshes reshard automatically; a mesh SPANNING PROCESSES
    (multi-controller ``jax.distributed`` runs) requires every jit input to
    be a GLOBAL array, so host values are device_put with a fully
    replicated ``NamedSharding`` — every process passes identical host
    data, the same pattern ``fit`` uses for the window store. ``None``
    mesh is the plain upload."""
    a = jnp.asarray(arr)
    if mesh is None:
        return a
    return jax.device_put(
        a, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    )


@jax.jit
def _predict_rows(table, rep, ids):
    rows = jnp.take(table, ids, axis=0)
    return jnp.dot(rows[:, :-1], rep, precision=SCORE_PRECISION) + rows[:, -1]


class ImplicitSequenceModel:
    """Base class implementing fit / user_representation / predict.

    Subclasses provide the tower (``_init_tower`` / ``_tower_apply``); the
    blanket ``OnlineRankingModel`` impl over ``SequenceModelParameters``
    (``src/models/sequence_model.rs:180-233``) corresponds to the methods
    here.
    """

    def __init__(self, hyper: Hyperparameters):
        self.hyper = hyper
        if hyper._mesh is None and hyper._num_threads > 1:
            # num_threads is the reference's data-parallel degree
            # (src/models/sequence_model.rs:91-102); here it requests a
            # (data=n, model=1) mesh, clamped to the devices present.
            n = min(hyper._num_threads, jax.device_count())
            if n > 1:
                from ..parallel import make_mesh

                hyper._mesh = make_mesh(
                    data=n, model=1, devices=jax.devices()[:n]
                )
        ns = hyper._mesh.shape.get("model", 1) if hyper._mesh is not None else 1
        if hyper._num_items % ns:
            # JAX shards an array only into equal blocks.
            raise ValueError(
                f"a table row-sharded over model={ns} needs num_items divisible "
                f"by {ns}, got {hyper._num_items}"
            )
        key = jax.random.PRNGKey(hyper._seed)
        k_emb, k_tower, self._key = jax.random.split(key, 3)
        init_table = lambda k: init_embedding_params(  # noqa: E731
            k, hyper._num_items, hyper._item_embedding_dim,
            dtype=hyper._table_dtype,
            init_scale=hyper._embedding_init_scale,
        )
        out_shardings = None
        if hyper._mesh is not None:
            # Generate the table already row-sharded: a table that only
            # the mesh can hold must never be built whole on one device.
            # One jitted program either way, so a sharded model starts
            # from the same bits as an unsharded one.
            from ..parallel.sharding import param_specs

            out_shardings = jax.tree_util.tree_map(
                lambda spec: jax.sharding.NamedSharding(hyper._mesh, spec),
                param_specs(jax.eval_shape(init_table, k_emb)),
            )
        params = jax.jit(init_table, out_shardings=out_shardings)(k_emb)
        params["tower"] = self._init_tower(k_tower, hyper._item_embedding_dim)
        self._params = params
        self._epoch_fn = None
        self._epoch_fn_shape = None
        self.history: Optional[FitHistory] = None
        if hyper._mesh is not None:
            from ..parallel.sharding import shard_model_params

            self._params = shard_model_params(self._params, hyper._mesh)

    # -- subclass hooks -----------------------------------------------------

    def _init_tower(self, key: jax.Array, dim: int) -> Dict:
        raise NotImplementedError

    def _tower_fn(self):
        """Return a PURE callable ``(tower_params, x [B,T,D], starts=None)
        -> hidden [B,T,D]`` that closes over configuration primitives only —
        never over ``self`` (compiled programs cached across instances would
        otherwise pin the first instance and read its config forever).
        ``starts [B, T]`` marks window boundaries in packed batches (reset
        the recurrent state there); None for one-window-per-row batches."""
        raise NotImplementedError

    def _tower_apply(self, tower_params: Dict, x: jnp.ndarray, starts=None) -> jnp.ndarray:
        return self._tower_fn()(tower_params, x, starts=starts)

    # -- engine wiring ------------------------------------------------------

    def _engine_config(self) -> EngineConfig:
        import os

        hp = self.hyper
        sparse = hp._sparse_updates
        if sparse is None:
            # Auto: dense full-table updates win while the table streams
            # cheaply (< ~16 MB); beyond that, touched-rows-only.
            sparse = hp._num_items * max(hp._item_embedding_dim, 1) > (1 << 22)
        # A row-sharded table must use the sparse path: the dense cotangent
        # would materialize per-shard full-size buffers.
        if hp._mesh is not None and hp._mesh.shape.get("model", 1) > 1:
            sparse = True

        return EngineConfig(
            num_items=hp._num_items,
            loss=hp._loss,
            optimizer=hp._optimizer,
            learning_rate=hp._learning_rate,
            l2_penalty=hp._l2_penalty,
            sparse_updates=sparse,
            lr_schedule=hp._lr_schedule,
        )

    def _build_fit_fn(
        self,
        batch_size: int,
        num_batches: int,
        num_epochs: int,
        num_windows: int,
        packed: bool,
    ):
        """The whole fit as ONE device program: a scan over epochs of a scan
        over shuffled minibatches — a single dispatch instead of one per
        step (the reference pays a full graph execution + optimizer step per
        *sequence*, ``src/models/sequence_model.rs:111-169``). Epoch
        shuffles are generated on device (the reference shuffles
        subsequences per epoch, ``src/models/sequence_model.rs:109``)."""
        train_step = make_train_step(
            self._engine_config(),
            self._tower_fn(),
            total_steps=num_batches * num_epochs,
        )
        mesh = self.hyper._mesh
        n_pad = num_batches * batch_size
        if mesh is not None:
            from ..parallel.sharding import batch_sharding

            data_spec = batch_sharding(mesh, 2)

        optimizer = self.hyper._optimizer

        def fit_fn(params, key, stream, mask, starts, lr, l2):
            # Fresh optimizer state per fit (the reference rebuilds the
            # optimizer each call, src/models/sequence_model.rs:90) —
            # created INSIDE the program, which costs no host dispatches. The model's root key
            # also advances INSIDE the program (key_next output): a
            # host-side jax.random.split costs several small dispatches
            # before the fit can start.
            opt_state = init_opt_state(optimizer, params)
            if mesh is not None:
                # Pin the state to the parameters' layout: left to
                # propagation, XLA may replicate the item table's
                # optimizer state on every device (a table-sized buffer
                # per device).
                from ..parallel.sharding import param_specs

                opt_state = jax.lax.with_sharding_constraint(
                    opt_state,
                    jax.tree_util.tree_map(
                        lambda spec: jax.sharding.NamedSharding(mesh, spec),
                        param_specs(opt_state),
                    ),
                )
            # Two nested 2-way splits, NOT one 3-way split: this reproduces
            # the historical host-side derivation (root -> (next, fit);
            # fit -> (steps, perm)) bit-for-bit, so the tuned integration
            # trajectories (PARITY.md) survive the move into the program.
            key_next, key_fit = jax.random.split(key)
            key_steps, key_perm = jax.random.split(key_fit)

            def batch_body(carry, batch_idx):
                params, opt_state, perm, epoch_idx = carry
                rows = jax.lax.dynamic_slice(
                    perm, (batch_idx * batch_size,), (batch_size,)
                )
                batch = {
                    "stream": jnp.take(stream, rows, axis=0),
                    "mask": jnp.take(mask, rows, axis=0),
                }
                if packed:
                    batch["starts"] = jnp.take(starts, rows, axis=0)
                if mesh is not None:
                    batch = {
                        k: jax.lax.with_sharding_constraint(v, data_spec)
                        for k, v in batch.items()
                    }
                step_key = jax.random.fold_in(
                    key_steps, epoch_idx * num_batches + batch_idx
                )
                params, opt_state, loss = train_step(
                    params, opt_state, step_key, batch, lr=lr, l2=l2
                )
                return (params, opt_state, perm, epoch_idx), loss

            def epoch_body(carry, epoch_idx):
                params, opt_state = carry
                perm = jax.random.permutation(
                    jax.random.fold_in(key_perm, epoch_idx), num_windows
                ).astype(jnp.int32)
                if n_pad > num_windows:
                    # padding rows point at the zero-mask sentinel window
                    perm = jnp.concatenate(
                        [perm, jnp.full((n_pad - num_windows,), num_windows, jnp.int32)]
                    )
                (params, opt_state, _, _), losses = jax.lax.scan(
                    batch_body,
                    (params, opt_state, perm, epoch_idx),
                    jnp.arange(num_batches),
                )
                return (params, opt_state), jnp.sum(losses)

            (params, opt_state), epoch_losses = jax.lax.scan(
                epoch_body, (params, opt_state), jnp.arange(num_epochs)
            )
            return params, epoch_losses, key_next

        return jax.jit(fit_fn, donate_argnums=(0,))

    # -- public API ----------------------------------------------------------

    def fit(self, interactions: CompressedInteractions) -> float:
        """Fit the model, returning the mean loss
        (``loss_sum / (1 + examples)``, reference
        ``src/models/sequence_model.rs:173-175``).

        Repeated calls continue training from the current parameters with a
        fresh optimizer state, matching the reference (the optimizer is
        rebuilt per ``fit``, ``src/models/sequence_model.rs:90``).
        """
        hp = self.hyper
        # Cache key: object identity (the cache HOLDS the object, so its id
        # cannot be recycled) plus a cheap content fingerprint guarding
        # against in-place mutation of the arrays.
        ids = interactions.item_ids
        ptrs = interactions.user_pointers
        # Order-sensitive weighted hash: catches sum-preserving in-place
        # permutations/edits of item_ids that a plain sum would miss.
        if len(ids):
            weights = np.arange(1, len(ids) + 1, dtype=np.uint64)
            id_hash = int((ids.astype(np.uint64) * weights).sum() % (2**61 - 1))
        else:
            id_hash = 0
        fingerprint = (
            len(interactions),
            interactions.num_users,
            interactions.num_items,
            int(ids.sum()) if len(ids) else 0,  # catches in-place edits
            id_hash,
            int(ptrs.sum()) if len(ptrs) else 0,  # catches pointer mutation
        )
        cache_key = (
            id(interactions), fingerprint, hp._max_sequence_length, hp._packed,
        )
        cached = getattr(self, "_window_cache", None)
        if cached is not None and cached[0] == cache_key:
            stream, mask, starts, n, num_examples = cached[2]
        else:
            padded = extract_padded_windows(interactions, hp._max_sequence_length)
            if len(padded) == 0:
                raise NoInteractions()
            if hp._packed:
                windows = pack_streams(padded, hp._max_sequence_length)
            else:
                windows = to_streams(padded)
            n = len(windows)
            num_examples = windows.num_examples

            # Data lives on device once; one zero-mask padding row at index n.
            def _with_sentinel(a):
                return np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])

            stream = _with_sentinel(windows.stream)
            mask = _with_sentinel(windows.mask)
            starts = (
                _with_sentinel(windows.starts)
                if windows.starts is not None
                else np.zeros((1, 1), np.float32)  # unused placeholder
            )
            if hp._mesh is not None:
                # Replicate the window store over the mesh (batch rows are
                # gathered per step and constrained to the data axis).
                repl = jax.sharding.NamedSharding(hp._mesh, jax.sharding.PartitionSpec())
                put = lambda a: jax.device_put(jnp.asarray(a), repl)
            else:
                put = jnp.asarray
            stream, mask, starts = put(stream), put(mask), put(starts)
            self._window_cache = (
                cache_key,
                interactions,  # keeps the id in cache_key valid
                (stream, mask, starts, n, num_examples),
            )

        batch_size = min(hp._batch_size, n)
        if hp._mesh is not None:
            # The batch is sharded over the data axis and must split evenly;
            # extra rows read the zero-mask sentinel window.
            dd = hp._mesh.shape.get("data", 1)
            batch_size = -(-batch_size // dd) * dd
        num_batches = -(-n // batch_size)  # ceil — no dropped windows

        # The compiled program bakes in everything the engine closes over —
        # shapes AND hyperparameters — so the cache key must cover both or a
        # later fit() after tweaking a hyperparameter would silently reuse
        # the stale program. lr and l2 are EXCLUDED: they enter the program
        # as traced scalars precisely so hyperopt sweeps reuse one compile.
        import dataclasses as _dc

        cfg_sans_lr = _dc.replace(
            self._engine_config(), learning_rate=0.0, l2_penalty=0.0
        )
        shape_key = (
            batch_size, num_batches, hp._num_epochs, stream.shape, hp._packed,
            cfg_sans_lr, id(hp._mesh), self._rep_fn_cache_key(),
        )
        if self._epoch_fn is None or self._epoch_fn_shape != shape_key:
            # Process-wide cache: hyperopt builds hundreds of models; trials
            # that differ only in lr/l2/seed share one compiled fit program
            # (lr/l2 are traced scalars; the seed never enters the program).
            full_key = (shape_key, None if hp._mesh is None else hp._mesh)
            cached_fn = self._FIT_FN_CACHE.get(full_key)
            if cached_fn is None:
                cached_fn = self._build_fit_fn(
                    batch_size, num_batches, hp._num_epochs, n, hp._packed
                )
                self._FIT_FN_CACHE[full_key] = cached_fn
            self._epoch_fn = cached_fn
            self._epoch_fn_shape = shape_key

        params = self._params
        t0 = time.perf_counter()
        try:
            # lr/l2 as NUMPY scalars: jnp.float32(...) would dispatch a
            # convert_element_type program (one dispatch each) before the
            # fit; numpy scalars upload with the call itself.
            params, epoch_losses, self._key = self._epoch_fn(
                params, self._key, stream, mask, starts,
                np.float32(hp._learning_rate), np.float32(hp._l2_penalty),
            )
        except Exception as exc:
            # params were donated to the (failed) program; depending on how
            # far dispatch got, the old buffers may already be deleted.
            # Surface that explicitly instead of a later cryptic
            # "Array has been deleted".
            raise FittingError(
                "fit() failed after parameter donation; the model's "
                "in-memory state may be unusable — restore from a "
                f"checkpoint. Original error: {exc!r}"
            ) from exc
        epoch_losses = np.asarray(epoch_losses)  # blocks until done
        wall_s = time.perf_counter() - t0

        self._params = params
        self._last_epoch_losses = epoch_losses
        self.history = FitHistory(
            epoch_losses=epoch_losses,
            examples_per_epoch=num_examples,
            num_epochs=hp._num_epochs,
            wall_s=wall_s,
        )
        logger.info(self.history.summary())
        total_loss = float(epoch_losses.sum())
        if not np.isfinite(total_loss):
            raise NonFiniteLoss(
                f"Training diverged: epoch losses {epoch_losses.tolist()}"
            )
        examples = num_examples * hp._num_epochs
        return total_loss / (1.0 + examples)

    # -- serving path --------------------------------------------------------

    # One compiled representation fn per tower configuration — NOT per model
    # instance (hyperopt fits hundreds of models; per-instance jit caches
    # would recompile the serving path every trial). LRU-bounded: random-
    # shape hyperopt sweeps must not grow compiled programs forever. 64
    # fit programs is far above any sweep's concurrent working set (trials
    # differing only in lr/l2/seed share ONE program).
    _REP_FN_CACHE = _LruCache(64)
    # Same story for the whole-fit program (keyed on shapes + the engine
    # config minus lr/l2, which are traced).
    _FIT_FN_CACHE = _LruCache(64)

    def _rep_fn_cache_key(self):
        """Subclasses with tower variants must extend this key."""
        hp = self.hyper
        return (type(self).__name__, hp._item_embedding_dim)

    def _build_rep_fn(self):
        # The mesh joins the key: under a mesh the jit pins REPLICATED
        # outputs (and multi-controller runs need exactly that to fetch
        # them with np.asarray on every process).
        mesh = self.hyper._mesh
        key = (self._rep_fn_cache_key(), mesh)
        cached = self._REP_FN_CACHE.get(key)
        if cached is not None:
            return cached
        # Close over the pure tower fn (config primitives only) — NOT self:
        # the cache outlives instances, and a pinned first instance would
        # leak its params and serve ITS config to later same-key models.
        tower_fn = self._tower_fn()

        def rep_fn(params, inputs, lengths):
            # f32 serving math regardless of the table's storage dtype.
            emb = jnp.take(params["item_table"][:, :-1], inputs, axis=0).astype(
                jnp.float32
            )  # [U, T, D]
            hidden = tower_fn(params["tower"], emb)
            last = jnp.clip(lengths - 1, 0, inputs.shape[1] - 1)
            return jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0, :]

        if mesh is not None:
            repl = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()
            )
            fn = jax.jit(rep_fn, out_shardings=repl)
        else:
            fn = jax.jit(rep_fn)
        self._REP_FN_CACHE[key] = fn
        return fn

    # -- parameter views -------------------------------------------------------

    @property
    def item_embeddings(self) -> np.ndarray:
        """Item embedding matrix ``[num_items, dim]`` (view of the fused table)."""
        return np.asarray(self._params["item_table"])[:, :-1]

    @property
    def item_biases(self) -> np.ndarray:
        """Item bias vector ``[num_items]`` (view of the fused table)."""
        return np.asarray(self._params["item_table"])[:, -1]

    def _representations(self, histories: Sequence[Sequence[int]]) -> np.ndarray:
        """Batched user representations: for each history, run the tower on
        the last ``max_sequence_length`` items and take the final state
        (reference ``src/models/sequence_model.rs:182-211``). An empty
        history behaves like ``[0]`` — the reference's index inputs default
        to item 0."""
        t = self.hyper._max_sequence_length
        u = len(histories)
        inputs = np.zeros((u, t), dtype=np.int32)
        lengths = np.zeros((u,), dtype=np.int32)
        for i, h in enumerate(histories):
            h = list(h)[-t:]
            if not h:
                h = [0]
            inputs[i, : len(h)] = h
            lengths[i] = len(h)
        # OOB ids would clamp silently under jit (jnp.take), scoring the
        # wrong item; fail like the reference does (index panic -> typed
        # error here).
        if u and (inputs.min() < 0 or inputs.max() >= self.hyper._num_items):
            raise InvalidPredictionValue(
                f"History contains item ids outside [0, {self.hyper._num_items})."
            )
        rep_fn = self._build_rep_fn()
        mesh = self.hyper._mesh
        reps = rep_fn(
            self._params,
            _replicated_put(mesh, inputs),
            _replicated_put(mesh, lengths),
        )
        return np.asarray(reps)

    def user_representation(self, item_ids: Sequence[int]) -> ImplicitUser:
        """Compute a user representation from interaction history
        (``src/lib.rs:105-108``)."""
        return ImplicitUser(user_embedding=self._representations([item_ids])[0])

    def user_representations(
        self, histories: Sequence[Sequence[int]]
    ) -> List[ImplicitUser]:
        """Batched :meth:`user_representation` — one device program for many
        users (the serving-path batching the reference cannot do: it builds
        a fresh graph per call, ``src/models/sequence_model.rs:186``)."""
        reps = self._representations(histories)
        return [ImplicitUser(user_embedding=r) for r in reps]

    def recommend(
        self,
        item_ids: Sequence[int],
        k: int = 10,
        exclude_seen: bool = True,
    ) -> List[int]:
        """Top-``k`` next items for a history (serving sugar; no reference
        counterpart — the reference leaves ranking to the caller). Scores
        the full catalog from the history's representation; with
        ``exclude_seen``, items already in the history are skipped (the
        convention :func:`sbr_rs_tpu.evaluation.mrr_score` evaluates
        under)."""
        return self.recommend_batch([item_ids], k=k, exclude_seen=exclude_seen)[0]

    # One compiled batched top-k scorer per (tower config, k) — shared
    # across instances like the rep fns (hyperopt builds hundreds).
    _TOPK_FN_CACHE = _LruCache(64)

    # Catalog chunk for the serving top-k: large enough to amortize the
    # per-chunk merge, small enough that [U, chunk] scores stay far from
    # device-memory limits at the serving batch size (4096 x 131072 f32 =
    # 2 GB).
    _SERVE_ITEM_CHUNK = 131072

    # Above this seen-list width, the fast post-filter path's k+S candidate
    # blow-up stops paying; fall back to per-chunk scatter masking.
    _SERVE_MAX_POSTFILTER_SEEN = 128

    # Streamed-exact phase-1 merge: when 2x the all-groups maxima buffer
    # (total_groups * U * 8 bytes) fits this budget, stack per-chunk maxima
    # and take ONE wide top-k instead of a running per-chunk merge (one
    # wide sort replaces one merge sort per chunk); otherwise use the
    # running per-chunk merge.
    _MERGE_BUFFER_BYTES = 6 << 30
    # Streamed-exact phase-2: candidate rows are re-scored in slot batches
    # sized so the gathered f32 block stays under this budget (the flat
    # block does not fit beside a large table; single-slot steps are
    # loop-bound).
    _PHASE2_BUFFER_BYTES = 1_200_000_000
    # Subgroup refinement on the single-pass merge path: phase 1 still
    # merges GROUP maxima (width _GROUP_TARGET), but the final kk candidate
    # units are picked at SUBGROUP width — phase 2 then gathers kk*sub rows
    # per user instead of kk*group. Phase 2 is random-row gather-latency
    # bound, so shrinking its row count is the lever; the extra cost is an
    # r-times-larger f32 maxima stack (gated by _SUBMAX_BUFFER_BYTES, falls
    # back up toward `group`) plus a tiny [U, kk*r] gather + top-k. Env
    # overrides SBR_SERVE_GROUP / SBR_SERVE_SUBGROUP for A/B.
    _GROUP_TARGET = 128
    _SUBGROUP_TARGET = 32
    _SUBMAX_BUFFER_BYTES = 6 << 30

    def _build_topk_fn(self, k: int, approximate: bool, recall_target: float):
        import os

        from ..ops.scoring import score_groupmax

        group_target = int(
            os.environ.get("SBR_SERVE_GROUP", self._GROUP_TARGET)
        )
        sub_target = int(
            os.environ.get("SBR_SERVE_SUBGROUP", self._SUBGROUP_TARGET)
        )
        mesh = self.hyper._mesh
        key = (
            self._rep_fn_cache_key(), k, approximate, recall_target,
            group_target, sub_target, mesh,
        )
        cached = self._TOPK_FN_CACHE.get(key)
        if cached is not None:
            return cached

        serve_chunk = self._SERVE_ITEM_CHUNK
        max_pf_seen = self._SERVE_MAX_POSTFILTER_SEEN
        # Buffer budgets captured as LOCALS: the dispatch closures below
        # live in the process-wide _TOPK_FN_CACHE, and a `self.` reference
        # inside them would pin up to 64 MODELS, tables included.
        merge_buffer_bytes = self._MERGE_BUFFER_BYTES
        submax_buffer_bytes = self._SUBMAX_BUFFER_BYTES
        phase2_buffer_bytes = self._PHASE2_BUFFER_BYTES

        # ``seen`` below is int32 [U, S], sorted ascending per row, invalid
        # slots = num_items (sorts last, can never match a candidate).

        def topk_small(params, reps, seen):
            # Small catalog (one chunk): dense [U, N] scores + one top-k.
            table = params["item_table"].astype(jnp.float32)
            scores = score_rows(reps, table)
            u = reps.shape[0]
            rows = jnp.arange(u)[:, None]
            scores = scores.at[rows, seen].set(-jnp.inf, mode="drop")
            return jax.lax.top_k(scores, min(k, table.shape[0]))

        def topk_streamed(params, reps, seen):
            # The catalog is STREAMED in static-shape chunks — a dense
            # [U, N] score matrix would be ~160 GB at the 10M-item catalogs
            # the training path handles. A straight per-chunk
            # ``lax.top_k`` would dominate the batch, and so would
            # per-chunk seen-masking scatters (random-address row
            # read-modify-writes). So:
            #
            # * Selection is EXACT TWO-PHASE over 128-item groups. Phase 1
            #   keeps the top-(k+S) GROUPS by group max — any group holding
            #   a true top-(k+S) item must rank there, because at most
            #   k+S-1 elements (hence at most that many other groups)
            #   exceed its value. The group max is computed on a TRANSPOSED
            #   [C, U] score layout: contiguous 128-row groups reduce
            #   along the leading axis with a free reshape.
            # * On the single-pass merge path the winning groups are
            #   refined one level down: phase 1 emits SUBGROUP maxima
            #   (width `sub` <= group), the merge runs on derived group
            #   maxima, and a tiny [U, kk*r] top-k picks the final kk
            #   subgroups — the refinement guarantee is the group argument
            #   one level down.
            # * Seen items are NOT masked during the stream; phase 2
            #   gathers the winning subgroups' (k+S)*sub candidate rows,
            #   re-scores them, drops seen candidates BY ID, and takes the
            #   exact top-k. With at most S seen items, at most S of the
            #   true top-(k+S) can be dropped, so k survivors remain —
            #   exact. (``approximate=True`` replaces phase 1+2 with
            #   ``lax.approx_max_k`` per chunk: returned values/ids are
            #   real, recall >= recall_target.)
            #
            # Equal scores exactly AT the k-th value may tie-break
            # differently than a dense argsort; values are exact.
            #
            # Chunks gather rows by CLIPPED id instead of slicing so every
            # chunk starts aligned at c*C with no final-chunk overlap
            # (clip repeats the last row; those columns are masked by id).
            table = params["item_table"]
            n = table.shape[0]
            s_width = seen.shape[1]
            num_chunks = -(-n // serve_chunk)
            group = min(group_target, serve_chunk)
            while serve_chunk % group:
                group -= 1  # largest width <= target dividing the chunk
            groups_per_chunk = serve_chunk // group
            u = reps.shape[0]
            kk = min(k + s_width, n)  # selection width before the seen filter
            k_out = min(k, n)
            reps_aug = jnp.concatenate([reps, jnp.ones((u, 1), reps.dtype)], axis=1)

            if approximate:

                def body(carry, c):
                    vals, idx = carry
                    lo = c * serve_chunk
                    ids = lo + jnp.arange(serve_chunk)
                    tc = jax.lax.optimization_barrier(
                        jnp.take(table, ids, axis=0, mode="clip")
                    ).astype(jnp.float32)
                    scores = score_rows(reps, tc)
                    scores = jnp.where(ids[None, :] < n, scores, -jnp.inf)
                    cv, cp = jax.lax.approx_max_k(
                        scores, min(kk, serve_chunk), recall_target=recall_target
                    )
                    mv = jnp.concatenate([vals, cv], axis=1)
                    mi = jnp.concatenate([idx, lo + cp], axis=1)
                    v, p = jax.lax.top_k(mv, kk)
                    return (v, jnp.take_along_axis(mi, p, axis=1)), None

                init = (
                    jnp.full((u, kk), -jnp.inf, jnp.float32),
                    jnp.broadcast_to(n + jnp.arange(kk, dtype=jnp.int32), (u, kk)),
                )
                (cvals, cand), _ = jax.lax.scan(
                    body, init, jnp.arange(num_chunks, dtype=jnp.int32)
                )
                cscores = jnp.where(cand < n, cvals, -jnp.inf)
            else:
                c_param = table.shape[1]
                total_groups = num_chunks * groups_per_chunk
                single_pass = (
                    total_groups * u * 8 <= merge_buffer_bytes
                )

                # Subgroup width for the final selection (see the class
                # constants): the phase-1 merge stays at `group`, but when
                # the single-pass merge is active phase 2 gathers kk*sub
                # rows instead of kk*group. The f32 submax stack costs r
                # times the group stack, so the width falls back up toward
                # `group` when the stack would exceed _SUBMAX_BUFFER_BYTES.
                sub = group
                if single_pass:
                    for d in range(max(1, sub_target), group + 1):
                        if group % d:
                            continue
                        stack_bytes = num_chunks * (serve_chunk // d) * u * 4
                        if stack_bytes > submax_buffer_bytes:
                            continue
                        sub = d
                        break
                r = group // sub
                subs_per_chunk = serve_chunk // sub
                total_subs = num_chunks * subs_per_chunk

                def chunk_submax(c):
                    """This chunk's subgroup maxima, [C/sub, U]."""
                    lo = c * serve_chunk
                    ids = lo + jnp.arange(serve_chunk)
                    tc = jax.lax.optimization_barrier(
                        jnp.take(table, ids, axis=0, mode="clip")
                    )
                    return score_groupmax(tc, reps_aug, lo, n, sub)

                def to_gmax(smax):
                    """Group maxima [G, U] from subgroup maxima [C/sub, U]."""
                    if r == 1:
                        return smax
                    return jnp.max(
                        smax.reshape(groups_per_chunk, r, u), axis=1
                    )

                # Phase-1 merge strategy: stacking every chunk's maxima and
                # taking ONE wide top-k replaces a merge sort per chunk. The
                # single pass needs ~2x total_groups*U*4 bytes of
                # transients, so it is gated by _MERGE_BUFFER_BYTES; bigger
                # catalogs or a lowered budget fall back to the running
                # merge, which keeps single-level selection (sub == group
                # there).
                if single_pass:
                    def body(carry, c):
                        return carry, chunk_submax(c)

                    _, stacked_sub = jax.lax.scan(
                        body, 0, jnp.arange(num_chunks, dtype=jnp.int32)
                    )  # [chunks, C/sub, U]
                    allsub = stacked_sub.reshape(total_subs, u)
                    # Group maxima for the wide merge, derived from the
                    # subgroup stack (the scan output is contiguous, so
                    # this reshape is free; stacking them separately would
                    # hold an extra total_groups*U*4 bytes).
                    allg = jnp.max(
                        allsub.reshape(total_groups, r, u), axis=1
                    ).T  # [U, G_all]
                    n_subs = allsub.shape[0]
                    n_groups = allg.shape[1]
                    w1 = min(kk, n_groups)
                    _, gids = jax.lax.top_k(allg, w1)
                    if r > 1:
                        # Level-2 refinement: among the winning groups'
                        # w1*r subgroups, keep the top kk by subgroup max.
                        # Exactness is the same argument one level down:
                        # any discarded element is bounded by every one of
                        # the kk selected subgroup maxima, each of which is
                        # itself in the candidate pool.
                        sids = (
                            gids[:, :, None] * r
                            + jnp.arange(r, dtype=gids.dtype)
                        ).reshape(u, w1 * r)
                        svals = jnp.take_along_axis(
                            allsub, sids.T, axis=0
                        ).T  # [U, w1*r]
                        _, sp = jax.lax.top_k(svals, min(kk, w1 * r))
                        gids = jnp.take_along_axis(sids, sp, axis=1)
                    sub_sentinel = n_subs
                else:
                    def body(carry, c):
                        vals, gids = carry
                        gmax = to_gmax(chunk_submax(c)).T  # [U, G]
                        cv, cp = jax.lax.top_k(gmax, min(kk, groups_per_chunk))
                        cg = c * groups_per_chunk + cp
                        mv = jnp.concatenate([vals, cv], axis=1)
                        mg = jnp.concatenate([gids, cg], axis=1)
                        v, p = jax.lax.top_k(mv, kk)
                        return (v, jnp.take_along_axis(mg, p, axis=1)), None

                    # Init group ids are DISTINCT and past the catalog: a
                    # slot the merge never displaces must produce
                    # out-of-range candidates (masked -inf below), never a
                    # duplicate of a real group.
                    init = (
                        jnp.full((u, kk), -jnp.inf, jnp.float32),
                        jnp.broadcast_to(
                            total_groups + jnp.arange(kk, dtype=jnp.int32),
                            (u, kk),
                        ),
                    )
                    (_, gids), _ = jax.lax.scan(
                        body, init, jnp.arange(num_chunks, dtype=jnp.int32)
                    )
                    sub_sentinel = total_subs

                # Phase 2: re-score the winning subgroups' candidates
                # exactly, a few SLOTS at a time (a lax.map over slot
                # batches) — the flat [U, kk*sub, D+1] candidate block is
                # ~10 GB at U=4096, kk=41, sub=128, so the slot-batch size
                # is set by _PHASE2_BUFFER_BYTES. The optimization_barrier
                # pins the convert to the GATHERED rows: without it XLA
                # hoists the f32 convert onto the whole table (a
                # catalog-sized copy). Augmented reps dot whole fused rows —
                # slicing into emb/bias would force a copy of every row.
                w = gids.shape[1]
                slot_bs = max(
                    1,
                    min(w, phase2_buffer_bytes // (u * sub * c_param * 4)),
                )
                w_pad = -(-w // slot_bs) * slot_bs
                if w_pad != w:
                    # Padding slots use the one-past-the-end subgroup id:
                    # its item ids are >= n (subgroups tile the catalog),
                    # so the id mask below drops them.
                    gids = jnp.pad(
                        gids, ((0, 0), (0, w_pad - w)),
                        constant_values=sub_sentinel,
                    )
                gsteps = gids.reshape(u, w_pad // slot_bs, slot_bs)
                gsteps = jnp.moveaxis(gsteps, 1, 0)  # [steps, U, sb]

                def score_slots(gcols):
                    ids = gcols[:, :, None] * sub + jnp.arange(sub)
                    rows_g = jnp.take(
                        table, ids.reshape(-1), axis=0, mode="clip"
                    )
                    rows_g = jax.lax.optimization_barrier(rows_g)
                    rows_g = rows_g.astype(jnp.float32).reshape(
                        u, slot_bs * sub, -1
                    )
                    return (
                        jnp.einsum(
                            "ue,uce->uc", reps_aug, rows_g,
                            precision=SCORE_PRECISION,
                        ),
                        ids.reshape(u, slot_bs * sub),
                    )

                slot_scores, slot_ids = jax.lax.map(score_slots, gsteps)
                cand = jnp.moveaxis(slot_ids, 0, 1).reshape(u, w_pad * sub)
                cscores = jnp.moveaxis(slot_scores, 0, 1).reshape(u, w_pad * sub)
                cscores = jnp.where(cand < n, cscores, -jnp.inf)

            # Drop seen candidates BY ID (broadcast compare against the sorted
            # seen rows — a per-chunk scatter mask costs random row RMWs).
            seen_hit = jnp.any(
                cand[:, :, None] == seen[:, None, :], axis=-1
            )
            cscores = jnp.where(seen_hit, -jnp.inf, cscores)
            v, p = jax.lax.top_k(cscores, k_out)
            return v, jnp.take_along_axis(cand, p, axis=1)

        def topk_streamed_bigseen(params, reps, seen):
            # Wide seen lists (> _SERVE_MAX_POSTFILTER_SEEN): the k+S
            # candidate width stops paying; stream chunks with per-chunk
            # scatter masking and a full per-chunk top-k merge. Slower
            # (top-k dominates) but correct for any S.
            table = params["item_table"]
            n = table.shape[0]
            num_chunks = -(-n // serve_chunk)
            u = reps.shape[0]
            rows = jnp.arange(u)[:, None]
            kk = min(k, n)

            def body(carry, c):
                vals, idx = carry
                lo = c * serve_chunk
                ids = lo + jnp.arange(serve_chunk)
                tc = jax.lax.optimization_barrier(
                    jnp.take(table, ids, axis=0, mode="clip")
                ).astype(jnp.float32)
                scores = score_rows(reps, tc)
                scores = jnp.where(ids[None, :] < n, scores, -jnp.inf)
                # Seen ids local to this chunk; ids from other chunks remap
                # OUT-OF-BOUNDS POSITIVELY (negatives wrap NumPy-style
                # instead of dropping).
                local = seen - lo
                local = jnp.where(local >= 0, local, serve_chunk)
                scores = scores.at[rows, local].set(-jnp.inf, mode="drop")
                cv, cp = jax.lax.top_k(scores, min(kk, serve_chunk))
                mv = jnp.concatenate([vals, cv], axis=1)
                mi = jnp.concatenate([idx, lo + cp], axis=1)
                v, p = jax.lax.top_k(mv, kk)
                return (v, jnp.take_along_axis(mi, p, axis=1)), None

            init = (
                jnp.full((u, kk), -jnp.inf, jnp.float32),
                # Distinct init ids: an all-masked user must not report the
                # same id k times.
                jnp.broadcast_to(jnp.arange(kk, dtype=jnp.int32), (u, kk)),
            )
            (vals, idx), _ = jax.lax.scan(
                body, init, jnp.arange(num_chunks, dtype=jnp.int32)
            )
            return vals, idx

        def dispatch(params, reps, seen):
            if params["item_table"].shape[0] <= serve_chunk:
                return topk_small(params, reps, seen)
            if seen.shape[1] > max_pf_seen:
                return topk_streamed_bigseen(params, reps, seen)
            return topk_streamed(params, reps, seen)

        if mesh is not None:
            repl = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()
            )
            fn = jax.jit(dispatch, out_shardings=repl)
        else:
            fn = jax.jit(dispatch)
        self._TOPK_FN_CACHE[key] = fn
        return fn

    def recommend_batch(
        self,
        histories: Sequence[Sequence[int]],
        k: int = 10,
        exclude_seen: bool = True,
        approximate: bool = False,
        recall_target: float = 0.95,
        return_scores: bool = False,
    ):
        """Batched :meth:`recommend`: top-``k`` next items for MANY
        histories in one device program — representations, full-catalog
        scoring, seen-item masking, and the top-k all run on device (the
        serving path a production ranker needs; the reference scores one
        user and one dot product at a time).

        ``approximate=True`` (large streamed catalogs only) selects with
        ``lax.approx_max_k``: returned items and scores are real, but each
        catalog chunk's recall is only guaranteed >= ``recall_target``.
        Exact selection is the default; the approximate mode remains for
        shapes where the two-phase guarantee degrades (very wide k+seen
        shortlists).

        ``return_scores=True`` additionally returns the items' scores
        (``dot(user, emb) + bias``, the same quantity :meth:`predict`
        computes, carried by the top-k program anyway; different program
        formulations of the dot may differ in the last float ulp) as a
        second ``[U, k]`` float array."""
        if not histories:
            return ([], np.zeros((0, k), np.float32)) if return_scores else []
        u = len(histories)
        reps = self._representations(histories)

        n = self.hyper._num_items
        max_seen = max((len(h) for h in histories), default=1) if exclude_seen else 1
        max_seen = max(max_seen, 1)
        # Sorted-ascending seen rows; invalid slots = num_items (sorts
        # last, never matches a candidate id).
        seen = np.full((u, max_seen), n, dtype=np.int32)
        if exclude_seen:
            for i, h in enumerate(histories):
                h = list(h)
                seen[i, : len(h)] = h
            seen.sort(axis=1)

        k = min(k, n)
        topk_fn = self._build_topk_fn(k, approximate, recall_target)
        mesh = self.hyper._mesh
        vals, idx = topk_fn(
            self._params,
            _replicated_put(mesh, reps.astype(np.float32)),
            _replicated_put(mesh, seen),
        )
        if return_scores:
            return np.asarray(idx).tolist(), np.asarray(vals)
        return np.asarray(idx).tolist()

    def predict(self, user: ImplicitUser, item_ids: "Sequence[int] | None" = None) -> np.ndarray:
        """Score ``item_ids`` for the user: ``dot(user, emb) + bias``
        (``src/models/lstm.rs:338-350``); ``None`` scores the full catalog.
        Raises :class:`InvalidPredictionValue` on non-finite scores
        (``src/models/sequence_model.rs:222-230``)."""
        if item_ids is None:
            item_ids = np.arange(self.hyper._num_items)
        ids_np = np.asarray(item_ids, dtype=np.int32)
        if len(ids_np) and (ids_np.min() < 0 or ids_np.max() >= self.hyper._num_items):
            raise InvalidPredictionValue(
                f"item_ids outside [0, {self.hyper._num_items})."
            )
        ids = jnp.asarray(ids_np)
        rep = jnp.asarray(np.asarray(user.user_embedding, dtype=np.float32))
        scores = np.asarray(_predict_rows(self._params["item_table"], rep, ids))
        if not np.all(np.isfinite(scores)):
            raise InvalidPredictionValue()
        return scores

    def clone(self) -> "ImplicitSequenceModel":
        """Independent copy: hyperparameters, parameters, and the serving/
        training PRNG state (the reference models derive ``Clone``,
        ``src/models/lstm.rs:386`` — minus the EWMA clone bug that aliases
        ``alpha`` into the dead fc1/fc2 params, ``src/models/ewma.rs:
        225-226``, which this build does not reproduce). Leaves are
        DEEP-COPIED: the whole-fit program donates its parameter buffers
        (``donate_argnums``), so shared storage would be deleted out from
        under the other model on its next fit."""
        hyper = type(self.hyper).from_dict(self.hyper.to_dict())
        if self.hyper._mesh is not None:
            hyper = hyper.mesh(self.hyper._mesh)
        m = hyper.build()
        m._params = jax.tree_util.tree_map(jnp.copy, self._params)
        m._key = jnp.copy(self._key)
        return m

    # -- checkpointing ---------------------------------------------------------

    def save(self, path: str) -> None:
        from ..utils.checkpoint import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str) -> "ImplicitSequenceModel":
        from ..utils.checkpoint import load_model

        return load_model(path)
