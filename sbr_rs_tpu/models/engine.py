"""The batched sequence-model training engine.

Batched replacement for the reference's ``fit_sequence_model``
(``src/models/sequence_model.rs:70-178``). The reference runs per-sequence
SGD — one graph execution and one optimizer step per subsequence, with WARP
negatives drawn by a serial rejection loop calling a SIMD dot per draw. Here
a whole ``[B, T]`` padded batch of windows is one XLA-compiled step:

1. negative *candidates* are sampled uniformly on device for every
   (batch, timestep) position — K=5 for WARP, K=1 otherwise
   (``src/models/sequence_model.rs:47-68, 125-138``);
2. input+positive rows are gathered from the fused item table once; WARP
   candidates are gathered, scored, and selected entirely under
   ``stop_gradient`` (the reference's first-margin-violator rule,
   :func:`sbr_rs_tpu.ops.sampling.warp_select`) so only the SELECTED
   negative joins the differentiated row set — the backward/scatter path
   touches 3*B*T rows, not (2+K)*B*T, and rejected draws get no gradient
   or L2, exactly like the reference. Selection happens INSIDE the
   differentiated loss so the single primal tower forward serves both
   selection and scoring by construction (one Pallas/scan fwd + one bwd
   per step, not relying on XLA CSE to merge duplicate forwards — CSE
   cannot be assumed for Mosaic custom calls under ``shard_map``);
3. the loss is differentiated with respect to the *gathered row copies*,
   never the full table — gradient cost scales with the batch, not the
   catalog; scores dot a bias-augmented hidden state against whole fused
   rows (no per-row column slicing);
4. the per-timestep pairwise loss is masked and summed (the reference's
   prefix-sum-of-losses trick is just a masked sum over valid timesteps,
   ``src/models/lstm.rs:322-328``);
5. the item table updates via one fused-row strategy
   (:mod:`sbr_rs_tpu.ops.optimizers`): dense scatter-add + touched-row
   update for small catalogs; sort + blocked-scan dedupe + unique-row
   scatter for huge ones; dense updates handle tower params.

Loss accounting matches the reference: the engine accumulates the summed
pre-update loss and the number of supervised timesteps ("examples",
``src/models/sequence_model.rs:157-158``), and ``fit`` returns
``loss_sum / (1 + examples)`` (``src/models/sequence_model.rs:173-175``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from ..models import Loss, Optimizer
from ..ops import optimizers as opt_ops
from ..ops.losses import pairwise_loss
from ..ops.sampling import WARP_CANDIDATES, warp_select_onehot


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_items: int
    loss: Loss
    optimizer: Optimizer
    learning_rate: float
    l2_penalty: float
    # Learning-rate schedule over the whole fit: "constant" (the reference's
    # behavior, src/models/lstm.rs:234-248), "linear" (decay to 0) or
    # "cosine". Batched synchronous training takes ~100x fewer optimizer
    # steps than the reference's per-sequence SGD; a decaying tail lowers
    # the variance of the final iterate (SURVEY.md §7 hard part 2).
    lr_schedule: str = "constant"
    # Update strategy for the item table/biases. "sparse" = sort+segment-sum
    # the touched rows, O(batch) memory traffic — required for huge catalogs.
    # "dense" = scatter-add cotangent + full-table update with touched-row
    # semantics — faster when the table is small (no sort on the hot path).
    sparse_updates: bool = True


def init_embedding_params(
    key: jax.Array, num_items: int, dim: int, dtype="float32",
    init_scale: float = 1.0,
) -> Dict[str, jnp.ndarray]:
    """The fused item table: embedding columns ``[:, :dim]`` N(0, 1/dim)
    (reference ``src/models/lstm.rs:22-25``) plus the bias as the LAST
    column, zero-initialized (``src/models/lstm.rs:181``).

    Fusing bias into the table makes each item ONE row for every
    gather/scatter on the hot path, and no per-step concatenation of a
    catalog-sized buffer ever happens (at 10M+ items that concat would
    cost more than the rest of the step combined).
    """
    dtype = jnp.dtype(dtype)
    # Generate in the storage dtype and append the zero bias column via pad
    # (no [N, 1] zeros operand is materialized).
    # init_scale is a tuning lever (base.Hyperparameters.embedding_init_
    # scale); at the default 1.0 the constant below is exactly 1/dim, so
    # existing tuned trajectories are reproduced bit-for-bit.
    emb = jax.random.normal(key, (num_items, dim), dtype=dtype) * jnp.asarray(
        init_scale / dim, dtype
    )
    return {"item_table": jnp.pad(emb, ((0, 0), (0, 1)))}


def table_embeddings(params: Dict) -> jnp.ndarray:
    """Embedding-columns view of the fused table."""
    return params["item_table"][:, :-1]


def table_biases(params: Dict) -> jnp.ndarray:
    """Bias-column view of the fused table."""
    return params["item_table"][:, -1]


def init_opt_state(kind: Optimizer, params: Dict) -> Dict:
    return {
        "step": jnp.zeros((), dtype=jnp.int32),
        "item_table": opt_ops.init_state(kind, params["item_table"]),
        "tower": jax.tree_util.tree_map(
            lambda p: opt_ops.init_state(kind, p), params["tower"],
            is_leaf=lambda x: isinstance(x, jnp.ndarray),
        ),
    }


def make_train_step(
    config: EngineConfig,
    tower_apply: Callable[[Dict, jnp.ndarray], jnp.ndarray],
    total_steps: int = 0,
) -> Callable:
    """Build the jittable training step.

    ``tower_apply(tower_params, input_embeddings [B,T,D]) -> hidden [B,T,D]``.

    Returns ``train_step(params, opt_state, key, batch) ->
    (params, opt_state, loss_sum)`` where ``batch`` has an int32 ``stream``
    ``[B, T + 1]`` (:class:`sbr_rs_tpu.data.StreamWindows` layout: input at
    position t is ``stream[:, t]``, its target is ``stream[:, t + 1]``) and
    float32 ``mask`` ``[B, T]``; ``loss_sum`` is the masked pre-update loss
    sum (reference reads loss before stepping,
    ``src/models/sequence_model.rs:156-161``).
    """
    is_warp = config.loss == Loss.WARP
    k_cand = WARP_CANDIDATES if is_warp else 1
    num_items = config.num_items
    kind = config.optimizer

    # Towers that take a train-time RNG (the attention tower's dropout) get
    # one derived by fold_in from the step key — a pure derivation that
    # leaves every existing key stream (candidate draws, epoch shuffles)
    # bit-identical, so tuned trajectories of rng-less towers never move.
    import inspect

    try:
        tower_accepts_rng = "rng" in inspect.signature(tower_apply).parameters
    except (TypeError, ValueError):  # builtins / opaque callables
        tower_accepts_rng = False

    def train_step(params, opt_state, key, batch, lr=None, l2=None):
        # lr/l2 may be passed as TRACED scalars so one compiled fit program
        # serves every (lr, l2) trial of a hyperopt sweep — LSTM+WARP
        # whole-fit compiles are slow and would otherwise rerun per trial. Omitted, the config's values are baked as constants.
        if lr is None:
            lr = config.learning_rate
        if l2 is None:
            l2 = config.l2_penalty
        stream = batch["stream"]  # [B, T + 1]
        mask = batch["mask"]  # [B, T]
        starts = batch.get("starts")  # packed layout: window-reset positions
        b = stream.shape[0]
        t = stream.shape[1] - 1

        # The fused table IS the parameter (embedding columns + bias column,
        # init_embedding_params): each item's embedding+bias gathers and
        # scatters as one row, and no catalog-sized buffer is ever built on
        # the step path.
        table = params["item_table"]
        c_param = table.shape[1]

        candidates = jax.random.randint(key, (b, t, k_cand), 0, num_items, dtype=jnp.int32)

        def gather(idx):
            # Gathered rows are promoted to f32: all score/gradient math is
            # full precision regardless of the table's storage dtype.
            # Gather with FLAT indices, reshape the result once: XLA picks
            # worse layouts for a multi-dim gather output.
            rows = jnp.take(table, idx.reshape(-1), axis=0)
            return rows.astype(jnp.float32).reshape(idx.shape + (c_param,))

        # ONE gather serves inputs and positives: within the stream layout
        # the target of position t IS the input of position t+1, so the
        # B*(T+1) stream rows carry what a separate inputs/targets layout
        # would gather as 2*B*T rows — and their gradients combine into one
        # scattered row set instead of two (row traffic is the measured
        # bottleneck of the step). Autodiff differentiates with respect to
        # the gathered COPIES, so the backward pass costs O(batch)
        # regardless of the catalog size.
        rows_s = gather(stream)

        def views(full):
            """(input embeddings [B,T,D], positive fused rows [B,T,D+1])."""
            return full[:, :t, :-1], full[:, 1:, :]

        if is_warp:
            # Forward-only candidate rows: K draws are scored but never join
            # the differentiated row set — grads/scatters touch ~2*B*T rows,
            # not (1+K)*B*T more; only the selected draw is a graph row,
            # exactly like the reference (rejected draws get no gradient or
            # L2, src/models/sequence_model.rs:47-68).
            cand_rows = jax.lax.stop_gradient(gather(candidates))

        def scored_loss(rows_s, neg_in, tower_params):
            """Masked loss sum (+ selected negatives as aux under WARP).

            ``neg_in`` is the differentiable stand-in for the selected
            negative rows: the gathered rows themselves when the negative
            is known up front (BPR/Hinge), or a ZERO array added onto the
            in-function gather under WARP — selection happens inside the
            differentiated region so the same tower forward serves both
            the WARP selection pass and the loss (the reference also
            reuses its forward values for sampling,
            src/models/sequence_model.rs:125-135; a separate
            stop_gradient'd selection forward would run the tower twice).
            Gradients attach to arguments, not provenance: adding the zero
            array re-exposes the stop_gradient'd gather as a leaf whose
            cotangent is exactly the selected rows' gradient, while XLA
            folds the add of zeros away in the primal.
            """
            in_emb, pos_rows = views(rows_s)

            if tower_accepts_rng:
                hidden = tower_apply(
                    tower_params, in_emb, starts=starts,
                    rng=jax.random.fold_in(key, 1),
                )  # [B, T, D]
            else:
                hidden = tower_apply(tower_params, in_emb, starts=starts)
            # Score against FUSED rows: hidden augmented with a ones column
            # dots the bias in for free, and the [*, D+1] gathered rows are
            # used as-is — no embedding/bias column slicing (which would
            # force a relayout copy of every gathered row).
            haug = jnp.concatenate([hidden, jnp.ones((b, t, 1), hidden.dtype)], -1)
            pos_score = jnp.einsum("bte,bte->bt", haug, pos_rows)

            if is_warp:
                # WARP selection is a forward-only decision made from
                # current values: everything below until the fresh gather
                # is under stop_gradient.
                haug0 = jax.lax.stop_gradient(haug)
                # The candidate-score reduce is bandwidth-bound in any
                # formulation: a fused kernel would re-materialize the
                # [B,T,K,C] operand at its interface.
                cand_score = jnp.einsum("bte,btke->btk", haug0, cand_rows)
                # Arithmetic one-hot selection: take_along_axis lowers to a
                # per-element gather; a K-wide multiply-sum is a handful of
                # fused elementwise ops.
                sel_onehot = warp_select_onehot(
                    jax.lax.stop_gradient(pos_score), cand_score
                )
                negatives = jnp.sum(
                    candidates * sel_onehot.astype(jnp.int32), axis=-1
                )
                # Values of the selected rows via a fresh BT-row gather
                # (selecting out of cand_rows by value is a per-element
                # take_along_axis), re-exposed as a differentiable leaf by
                # the zero-add.
                neg_rows = jax.lax.stop_gradient(gather(negatives)) + neg_in
            else:
                negatives = None
                neg_rows = neg_in

            neg_score = jnp.einsum("bte,bte->bt", haug, neg_rows)

            losses = pairwise_loss(config.loss, pos_score, neg_score)
            return jnp.sum(losses * mask), negatives

        step = opt_state["step"]
        if config.lr_schedule == "linear" and total_steps:
            lr = lr * (1.0 - step.astype(jnp.float32) / total_steps)
        elif config.lr_schedule == "cosine" and total_steps:
            lr = lr * 0.5 * (
                1.0 + jnp.cos(jnp.pi * step.astype(jnp.float32) / total_steps)
            )
        elif config.lr_schedule == "warmup_cosine" and total_steps:
            # Linear warmup over the first 10% of steps, cosine decay after.
            warm = max(1.0, 0.1 * total_steps)
            s = step.astype(jnp.float32)
            lr = lr * jnp.where(
                s < warm,
                (s + 1.0) / warm,
                0.5 * (1.0 + jnp.cos(jnp.pi * (s - warm) / max(1.0, total_steps - warm))),
            )

        if is_warp:
            neg_in = jnp.zeros((b, t, c_param), jnp.float32)
        else:
            neg_in = gather(candidates[:, :, 0])
        (loss_sum, negatives), (d_s, d_neg, d_tower) = jax.value_and_grad(
            scored_loss, argnums=(0, 1, 2), has_aux=True
        )(rows_s, neg_in, params["tower"])
        if negatives is None:
            negatives = candidates[:, :, 0]
        d_rows = jnp.concatenate(
            [d_s.reshape(-1, c_param), d_neg.reshape(-1, c_param)]
        )

        mask_flat = mask.reshape(-1) > 0
        mask_b = mask > 0
        zero_col = jnp.zeros((b, 1), bool)
        # Stream-slot occurrence flags: slot p is an input occurrence iff
        # position p is supervised, a target occurrence iff position p-1 is.
        in_occ = jnp.concatenate([mask_b, zero_col], axis=1).reshape(-1)
        tg_occ = jnp.concatenate([zero_col, mask_b], axis=1).reshape(-1)
        occ_valid = jnp.concatenate([in_occ | tg_occ, mask_flat])
        # Input occurrences touch only the embedding columns — the bias of a
        # row touched only as an input gets no L2/state/step (the reference
        # keeps biases as a separate parameter inputs never index,
        # src/models/lstm.rs:272-291).
        bias_occ = jnp.concatenate([tg_occ, mask_flat])
        flat_idx = jnp.concatenate([stream.reshape(-1), negatives.reshape(-1)])

        if config.sparse_updates:
            dd, summed, bias_valid = opt_ops.dedupe_and_sum(
                flat_idx, occ_valid, d_rows, bias_occ, num_items
            )
            new_table, table_state = opt_ops.sparse_update(
                kind, lr, l2,
                table, opt_state["item_table"],
                dd, summed, step,
                bias_valid=bias_valid,
            )
        else:
            # Small catalog: ONE scatter-add accumulates the row cotangents
            # (embedding+bias fused) plus touched-row and bias-touched
            # counts.
            scatter_idx = jnp.where(occ_valid, flat_idx, num_items)
            payload = jnp.concatenate(
                [
                    d_rows,
                    jnp.ones((d_rows.shape[0], 1), d_rows.dtype),
                    bias_occ[:, None].astype(d_rows.dtype),
                ],
                axis=1,
            )
            d_aug = (
                jnp.zeros((num_items, payload.shape[1]), payload.dtype)
                .at[scatter_idx]
                .add(payload, mode="drop")
            )
            touched = d_aug[:, -2] > 0
            bias_touched = d_aug[:, -1] > 0
            new_table, table_state = opt_ops.dense_row_update(
                kind, lr, l2,
                table, opt_state["item_table"],
                d_aug[:, :-2], touched, step,
                bias_touched=bias_touched,
            )

        is_arr = lambda x: isinstance(x, jnp.ndarray)
        tower_updates = jax.tree_util.tree_map(
            lambda p, s, g: opt_ops.dense_update(kind, lr, l2, p, s, g, step),
            params["tower"], opt_state["tower"], d_tower,
            is_leaf=is_arr,
        )
        new_tower = jax.tree_util.tree_map(
            lambda upd: upd[0], tower_updates, is_leaf=lambda x: isinstance(x, tuple)
        )
        new_tower_state = jax.tree_util.tree_map(
            lambda upd: upd[1], tower_updates, is_leaf=lambda x: isinstance(x, tuple)
        )

        new_params = {"item_table": new_table, "tower": new_tower}
        new_opt_state = {
            "step": step + 1,
            "item_table": table_state,
            "tower": new_tower_state,
        }
        return new_params, new_opt_state, loss_sum

    return train_step
