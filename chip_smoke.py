"""Smoke test of the main path on NVIDIA GPUs: fit, eval and serving.

Runs the entry points a user calls (``fit``, ``evaluation.mrr_score``,
``recommend_batch``) on seeded random data and checks what comes out
against plain references. Phases:

  a  the device: GPU devices only; card name and power limit; which
     precision XLA gives float32 dots in each scoring/training formulation
  b  the LSTM recurrence kernel against the ``lax.scan`` tower (B=256,
     T=32, D=8 and 32, both variants, packed starts, forward and
     gradient), and both timed: forward+backward alone and a whole ``fit``
  c  the headline configuration at ML-100K's shape: fit, MRR, top-10
  d  the streamed path at 10M items: fit, streamed MRR, streamed top-10
  e  (only with ``--cards 4``) a (data=2, model=2) mesh against one card
     at 1.1M items, then 100M items row-sharded over four cards

Usage::

    python chip_smoke.py              # phases a-d on one GPU
    python chip_smoke.py --cards 4    # phase e on four GPUs

Every check prints its error beside its tolerance, and every time is
printed with the card's name and power limit. The last line of standard
output is one JSON object naming the device. The script exits non-zero,
and prints no result, when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_FAILED = []


def check(ok: bool, what: str) -> None:
    print(f"  {'PASS' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        _FAILED.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return "; ".join(sorted(set(line.strip() for line in out)))


def timed(fn, n: int):
    """Median wall seconds of ``n`` calls of ``fn`` (which must block)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def tie_tol(x) -> np.ndarray:
    """Last-ulp band of a float32 score. Two formulations of the same dot
    (float32 sums of 33 to 128 products taken in different orders) may
    differ by a few ulps, which may reorder items whose scores tie within
    that band: the documented tie class of the batched and streamed
    paths."""
    with np.errstate(over="ignore"):
        band = 16 * np.spacing(np.abs(np.asarray(x, np.float32)))
    return np.minimum(band, np.finfo(np.float32).max)


# -- references ------------------------------------------------------------------


def _local_ids(rows, base, width):
    """Per-user id lists as an int32 [U, S] array of ids local to the
    window ``[base, base + width)``; ids outside it become ``width``."""
    s = max(1, max((len(r) for r in rows), default=1))
    out = np.full((len(rows), s), width, np.int64)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.int64) - base
        r = r[(r >= 0) & (r < width)]
        out[i, : len(r)] = r
    return out.astype(np.int32)


def _slabs(table):
    """``(first row, rows on one device)`` for each distinct row slab."""
    shards = {}
    for s in table.addressable_shards:
        shards.setdefault(s.index[0].start or 0, s.data)
    return sorted(shards.items())


@functools.lru_cache(maxsize=None)
def _ref_programs():
    import jax
    import jax.numpy as jnp

    neg_min = float(np.finfo(np.float32).min)

    def scores(rows, reps):
        rows = rows.astype(jnp.float32)
        return jnp.dot(reps, rows[:, :-1].T, precision="highest") + rows[:, -1]

    @functools.partial(jax.jit, static_argnames="k")
    def topk(rows, reps, seen, *, k):
        s = scores(rows, reps)
        s = s.at[jnp.arange(s.shape[0])[:, None], seen].set(-jnp.inf, mode="drop")
        return jax.lax.top_k(s, k)

    @jax.jit
    def count(rows, reps, prefix, test, targets, tol):
        s = scores(rows, reps)
        u = jnp.arange(s.shape[0])[:, None]
        s = s.at[u, prefix].set(neg_min, mode="drop")
        s = s.at[u, test[:, None]].set(-jnp.inf, mode="drop")  # counted as 1 below
        ge = jnp.sum(s >= targets[:, None], axis=1)
        band = jnp.sum(jnp.abs(s - targets[:, None]) <= tol[:, None], axis=1)
        return ge, band

    return topk, count


def ref_topk(table, reps, seen_rows, k, chunk):
    """Exact top-``k`` ids and scores from dense float32 scores at
    ``highest`` precision, a catalog chunk at a time on each slab's own
    device; ``seen_rows[u]`` are excluded."""
    import jax

    topk, _ = _ref_programs()
    vals, ids = [], []
    for lo, slab in _slabs(table):
        dev = list(slab.devices())[0]
        r = jax.device_put(np.asarray(reps, np.float32), dev)
        for c0 in range(0, slab.shape[0], chunk):
            rows = slab[c0 : c0 + chunk]
            seen = jax.device_put(_local_ids(seen_rows, lo + c0, rows.shape[0]), dev)
            v, i = topk(rows, r, seen, k=min(k, rows.shape[0]))
            vals.append(np.asarray(v))
            ids.append(np.asarray(i, np.int64) + lo + c0)
    v, i = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-v, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(i, order, 1), np.take_along_axis(v, order, 1)


def ref_ranks(table, reps, test_items, prefixes, chunk):
    """Ranks under the per-user ``predict`` protocol of
    ``evaluation._ranks_generic``: prefix items masked to float32-min, the
    held-out item counted once, every other item that scores ``>=`` it
    counted. Also returns, per user, how many other items tie with the
    target within :func:`tie_tol` (the allowance of a comparison)."""
    import jax

    _, count = _ref_programs()
    neg_min = np.float32(np.finfo(np.float32).min)
    rows_t = np.asarray(table[np.asarray(test_items)], np.float64)
    targets = (np.einsum("ud,ud->u", rows_t[:, :-1], np.asarray(reps, np.float64))
               + rows_t[:, -1]).astype(np.float32)
    in_prefix = np.array([int(t) in set(np.asarray(p).tolist())
                          for t, p in zip(test_items, prefixes)])
    targets = np.where(in_prefix, neg_min, targets)
    tol = tie_tol(targets)
    ranks = np.ones(len(test_items), np.int64)
    band = np.zeros(len(test_items), np.int64)
    for lo, slab in _slabs(table):
        dev = list(slab.devices())[0]
        put = lambda a: jax.device_put(a, dev)
        r, tg, tl = put(np.asarray(reps, np.float32)), put(targets), put(tol)
        for c0 in range(0, slab.shape[0], chunk):
            rows = slab[c0 : c0 + chunk]
            w = rows.shape[0]
            pre = put(_local_ids(prefixes, lo + c0, w))
            tst = put(_local_ids([[t] for t in test_items], lo + c0, w)[:, 0])
            ge, b = count(rows, r, pre, tst, tg, tl)
            ranks += np.asarray(ge)
            band += np.asarray(b)
    return ranks, band


def compare_lists(got_ids, got_vals, ref_ids, ref_vals, score_of, label):
    """Top-k lists must be equal, except for swaps of items whose scores
    tie within :func:`tie_tol`; returned scores must match the float64
    scores of the same ids."""
    got_ids = np.asarray(got_ids)
    same = np.all(got_ids == ref_ids, axis=1)
    bad = 0
    for u in np.nonzero(~same)[0]:
        g = score_of(u, got_ids[u])
        if not np.all(np.abs(g - ref_vals[u]) <= tie_tol(ref_vals[u])):
            bad += 1
    check(
        bad == 0,
        f"{label}: {int(same.sum())}/{len(same)} top-10 lists identical to the "
        f"dense highest-precision reference; {bad} differ beyond the last-ulp tie "
        f"class (tolerance 0)",
    )
    got_vals = np.asarray(got_vals, np.float64)
    want = np.stack([score_of(u, got_ids[u]) for u in range(len(got_ids))])
    rel = float(np.max(np.abs(got_vals - want)) / max(np.max(np.abs(want)), 1e-30))
    check(rel <= 1e-5, f"{label}: returned scores max rel err {rel:.3e} vs float64 "
          f"(tolerance 1e-5)")


def compare_ranks(got, want, allowance, label):
    """Ranks must agree, or differ by no more than the number of other
    items tied with the target within the last-ulp band."""
    got = np.asarray(got)
    want = np.asarray(want)
    diff = np.abs(got - want)
    ok = diff <= allowance
    check(
        bool(np.all(ok)),
        f"{label}: {int(np.sum(diff == 0))}/{len(got)} ranks identical to the "
        f"reference; max |diff| {int(diff.max()) if len(diff) else 0}, "
        f"{int(np.sum(~ok))} outside the last-ulp tie class (tolerance 0)",
    )


def f64_scorer(table, reps):
    """``score_of(u, ids)``: float64 scores of rows ``ids`` for user ``u``."""

    def score_of(u, ids):
        rows = np.asarray(table[np.asarray(ids)], np.float64)
        return (rows[:, :-1] @ np.asarray(reps[u], np.float64) + rows[:, -1]).astype(np.float32)

    return score_of


# -- phase a ---------------------------------------------------------------------


def phase_device(expect: int):
    import jax

    devices = jax.devices()
    kinds = sorted({d.device_kind for d in devices})
    print(f"[a] devices: {len(devices)} x {kinds} platform={devices[0].platform}")
    if any(d.platform != "gpu" for d in devices):
        print("chip_smoke: JAX found no GPU; nothing was run", file=sys.stderr)
        sys.exit(2)
    if len(devices) < expect:
        print(f"chip_smoke: {expect} GPUs needed, {len(devices)} found", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(f"[a] card: {card}")
    return card


def phase_precision(card: str):
    """Which precision XLA gives the float32 dots of each path at the
    default setting: the error of each formulation against float64."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    x, w = f32(8192, 32), f32(32, 128)
    h, cand = f32(256, 32, 33), f32(256, 32, 5, 33)
    reps, emb = f32(512, 32), f32(65536, 32)
    rows1, reps1 = f32(131072, 128), f32(512, 128)
    rows2 = f32(512, 1024, 128)
    # (what, jax formulation, float64 NumPy formulation, operands)
    probes = [
        ("training tower projection x @ w_x", lambda a, b: a @ b,
         lambda a, b: a @ b, (x, w)),
        ("WARP candidate scoring einsum bte,btke->btk",
         lambda a, b: jnp.einsum("bte,btke->btk", a, b),
         lambda a, b: np.einsum("bte,btke->btk", a, b), (h, cand)),
        ("eval counter reps @ chunk.T", lambda a, b: a @ b.T,
         lambda a, b: a @ b.T, (reps, emb)),
        ("serving phase 1 rows . reps -> [C, U]",
         lambda a, b: jax.lax.dot_general(a, b, (((1,), (1,)), ((), ()))),
         lambda a, b: a @ b.T, (rows1, reps1)),
        ("serving phase 2 einsum ue,uce->uc",
         lambda a, b: jnp.einsum("ue,uce->uc", a, b),
         lambda a, b: np.einsum("ue,uce->uc", a, b), (reps1, rows2)),
    ]
    for name, fn, fn64, args in probes:
        got = np.asarray(jax.jit(fn)(*args), np.float64)
        want = fn64(*[np.asarray(a, np.float64) for a in args])
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        kind = "TF32-class" if rel > 1e-5 else "float32"
        print(f"[a] precision at XLA default: {name}: max rel err vs float64 "
              f"{rel:.3e} -> {kind}")


# -- phase b ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scan_lstm():
    """The LSTM model with the ``lax.scan`` tower on every backend: the
    other side of the kernel's A/B, and the one-card side of the mesh
    parity (a mesh runs the scan tower)."""
    from sbr_rs_tpu.models import lstm

    class ScanLSTM(lstm.ImplicitLSTMModel):
        def _pallas_enabled(self) -> bool:
            return False

    return ScanLSTM


def _headline(sbr, num_items, epochs, seed=42, scan=False):
    from sbr_rs_tpu.models import Loss, Optimizer, lstm

    hp = (
        lstm.Hyperparameters(num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(epochs)
        .batch_size(256)
        .packed(True)
        .from_seed(seed)
    )
    return _scan_lstm()(hp) if scan else hp.build()


def _ml100k_split(sbr, seed):
    data = sbr.datasets.movielens_100k_shaped(seed)
    train, test = sbr.data.user_based_split(data, np.random.default_rng(seed), 0.2)
    return data, train.to_compressed(), test.to_compressed()


def phase_kernel(card: str, seed: int):
    import jax
    import jax.numpy as jnp

    import sbr_rs_tpu as sbr
    from sbr_rs_tpu.models.towers import init_lstm, lstm_apply
    from sbr_rs_tpu.ops.pallas_lstm import MAX_KERNEL_WIDTH, lstm_apply_pallas

    b, t = 256, 32
    tol = 1e-4
    print("[b] kernel dots: IEEE float32 (precision=HIGHEST); reference: lax.scan "
          "tower under jax.default_matmul_precision('highest')")
    print(f"[b] D=128 (the ML-1M LSTM-128): the kernel runs only up to padded width "
          f"{MAX_KERNEL_WIDTH} (on an H100 it was 7.7x slower than the scan at 64, and "
          f"its backward needs 288 KB of shared memory at 128, a block has 227 KB); "
          f"the scan tower runs there. Checked instead: D=8 (padded to 16) and D=32")
    for d in (8, 32):
        for coupled in (False, True):
            k = jax.random.split(jax.random.PRNGKey(seed + d), 4)
            params = init_lstm(k[0], d, coupled)
            x = jax.random.normal(k[1], (b, t, d))
            starts = (jax.random.uniform(k[2], (b, t)) < 0.1).astype(jnp.float32)
            starts = starts.at[:, 0].set(1.0)
            cot = jax.random.normal(k[3], (b, t, d))

            def loss(f):
                return lambda p, xx: jnp.sum(f(p, xx, coupled=coupled, starts=starts) * cot)

            with jax.default_matmul_precision("highest"):
                want_h = jax.jit(lambda p, xx: lstm_apply(p, xx, coupled=coupled, starts=starts))(params, x)
                got_h = jax.jit(lambda p, xx: lstm_apply_pallas(p, xx, coupled=coupled, starts=starts))(params, x)
                want_g = jax.jit(jax.grad(loss(lstm_apply), argnums=(0, 1)))(params, x)
                got_g = jax.jit(jax.grad(loss(lstm_apply_pallas), argnums=(0, 1)))(params, x)
            ref = np.asarray(want_h, np.float64)
            abs_f = float(np.max(np.abs(np.asarray(got_h, np.float64) - ref)))
            rel_f = abs_f / float(np.max(np.abs(ref)))
            rel_g = 0.0
            for gg, ww in zip(jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
                ww = np.asarray(ww, np.float64)
                rel_g = max(rel_g, float(np.max(np.abs(np.asarray(gg, np.float64) - ww)) / max(np.max(np.abs(ww)), 1e-30)))
            variant = "coupled" if coupled else "normal"
            check(
                rel_f <= tol and rel_g <= tol,
                f"[b] kernel vs scan D={d} {variant} packed B={b} T={t}: forward max abs "
                f"{abs_f:.3e} max rel {rel_f:.3e}; gradient max rel {rel_g:.3e} (tolerance {tol:g})",
            )

    # Forward+backward alone, at the default precision training uses.
    for d in (16, 32):
        k = jax.random.split(jax.random.PRNGKey(seed), 3)
        params = init_lstm(k[0], d, False)
        x = jax.random.normal(k[1], (b, t, d))
        starts = jnp.zeros((b, t)).at[:, 0].set(1.0)
        res = {}
        for name, f in (("kernel", lstm_apply_pallas), ("scan", lstm_apply)):
            step = jax.jit(jax.value_and_grad(
                lambda p, xx: jnp.sum(f(p, xx, coupled=False, starts=starts) ** 2),
                argnums=(0, 1)))
            jax.block_until_ready(step(params, x))
            res[name] = timed(lambda: jax.block_until_ready(step(params, x)), 50)
        print(f"[b] time fwd+bwd D={d} normal B={b} T={t}: kernel "
              f"{res['kernel'] * 1e3:.4f} ms, scan {res['scan'] * 1e3:.4f} ms "
              f"(median of 50) | {card}")

    # The whole fit of phase c, each tower.
    data, train, _ = _ml100k_split(sbr, seed)
    res = {}
    for name, scan in (("kernel", False), ("scan", True)):
        model = _headline(sbr, data.num_items, 10, seed=seed, scan=scan)
        check(model._pallas_enabled() is not scan,
              f"[b] the {name} model's tower: "
              f"{'LSTM kernel' if model._pallas_enabled() else 'lax.scan'}")
        model.fit(train)  # compile
        res[name] = timed(lambda: model.fit(train), 5)
    print(f"[b] time fit (10 epochs, phase c config): kernel {res['kernel']:.4f} s, "
          f"scan {res['scan']:.4f} s (median of 5) | {card}")


# -- phase c ---------------------------------------------------------------------


def phase_main(card: str, seed: int):
    import sbr_rs_tpu as sbr
    from sbr_rs_tpu import evaluation

    data, train, test = _ml100k_split(sbr, seed)
    print(f"[c] data: synthetic ML-100K-shaped (seed {seed}): {data.num_users} users x "
          f"{data.num_items} items, {len(data)} events")
    model = _headline(sbr, data.num_items, 10, seed=seed)
    print(f"[c] tower chosen: {'LSTM kernel' if model._pallas_enabled() else 'lax.scan'}")
    t0 = time.perf_counter()
    loss = model.fit(train)
    fit_s = time.perf_counter() - t0
    losses = model.history.epoch_losses
    check(np.isfinite(loss) and bool(np.all(np.isfinite(losses))),
          f"[c] fit loss finite: mean {loss:.6f}")
    check(losses[-1] < losses[0],
          f"[c] loss falls: epoch 1 {losses[0]:.4f} -> epoch {len(losses)} {losses[-1]:.4f}")
    print(f"[c] time first fit (compile included): {fit_s:.4f} s | {card}")

    mrr = evaluation.mrr_score(model, test)
    chance = float(np.mean(1.0 / np.arange(1, data.num_items + 1)))
    check(np.isfinite(mrr) and mrr > chance,
          f"[c] MRR {mrr:.6f} finite and above chance {chance:.6f}")
    ranks_b = evaluation._ranks_batched(model, test)
    ranks_g = evaluation._ranks_generic(model, test)
    users = [u for u in test.iter_users() if len(u) >= 2]
    allowance = np.zeros(len(users), np.int64)
    for i in np.nonzero(ranks_b != ranks_g)[0]:
        u = users[i]
        p = model.predict(model.user_representation(u.item_ids[:-1]))
        tgt = p[int(u.item_ids[-1])]
        allowance[i] = int(np.sum(np.abs(p - tgt) <= tie_tol(tgt))) - 1
    compare_ranks(ranks_b, ranks_g, allowance,
                  "[c] batched ranks vs per-user predict path (evaluation._ranks_generic)")

    histories = [list(u.item_ids) for u in users][:256]
    histories += [list(u.item_ids) for u in train.iter_users()][: 256 - len(histories)]
    ids, vals = model.recommend_batch(histories, k=10, return_scores=True)
    reps = model._representations(histories)
    table = model._params["item_table"]
    ref_ids, ref_vals = ref_topk(table, reps, histories, 10, 1 << 20)
    compare_lists(ids, vals, ref_ids, ref_vals, f64_scorer(table, reps),
                  f"[c] recommend_batch(k=10) for {len(histories)} users")
    t_fit = timed(lambda: model.fit(train), 3)
    t_eval = timed(lambda: evaluation.mrr_score(model, test), 3)
    t_rec = timed(lambda: model.recommend_batch(histories, k=10), 3)
    print(f"[c] time fit {t_fit:.4f} s (10 epochs), mrr_score {t_eval:.4f} s "
          f"({len(users)} users), recommend_batch {t_rec:.4f} s ({len(histories)} users) "
          f"(median of 3) | {card}")


# -- phase d ---------------------------------------------------------------------


def _large_model(num_items, epochs, seed, mesh=None):
    from sbr_rs_tpu.models import Loss, Optimizer, lstm

    hp = (
        lstm.Hyperparameters(num_items, 64)
        .embedding_dim(127)
        .learning_rate(0.1)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(epochs)
        .batch_size(256)
        .packed(True)
        .sparse_updates(True)
        .from_seed(seed)
    )
    if mesh is not None:
        hp = hp.mesh(mesh)
    return hp.build()


def streamed_checks(card, tag, model, num_items, train, test, n_ref, chunk, repeats=3):
    """Fit, streamed MRR and streamed top-10 on a large catalog, checked
    for the first ``n_ref`` eval users against :func:`ref_ranks` and
    :func:`ref_topk`."""
    from sbr_rs_tpu import evaluation

    t0 = time.perf_counter()
    loss = model.fit(train)
    fit_s = time.perf_counter() - t0
    losses = model.history.epoch_losses
    check(np.isfinite(loss) and bool(np.all(np.isfinite(losses))),
          f"{tag} fit loss finite: mean {loss:.6f}")
    check(losses[-1] < losses[0],
          f"{tag} loss falls: epoch 1 {losses[0]:.4f} -> epoch {len(losses)} {losses[-1]:.4f}")
    steps = model.history.num_epochs
    print(f"{tag} time first fit (compile included) {fit_s:.4f} s | {card}")

    t0 = time.perf_counter()
    mrr = evaluation.mrr_score(model, test)
    eval_first = time.perf_counter() - t0
    chance = float(np.sum(1.0 / np.arange(1, num_items + 1)) / num_items)
    check(np.isfinite(mrr) and mrr > chance,
          f"{tag} streamed MRR {mrr:.6e} finite and above chance {chance:.3e}")
    users = [u for u in test.iter_users() if len(u) >= 2]
    ranks_b = evaluation._ranks_batched(model, test)
    histories = [list(u.item_ids) for u in users]
    ids, vals = model.recommend_batch(histories, k=10, return_scores=True)

    sub = users[:n_ref]
    table = model._params["item_table"]
    reps = model._representations([u.item_ids[:-1] for u in sub])
    ref, band = ref_ranks(
        table, reps, np.array([int(u.item_ids[-1]) for u in sub], np.int64),
        [u.item_ids[:-1] for u in sub], chunk,
    )
    compare_ranks(ranks_b[:n_ref], ref, band,
                  f"{tag} streamed ranks vs dense highest-precision reference ({n_ref} users)")
    rec_reps = model._representations(histories[:n_ref])
    ref_ids, ref_vals = ref_topk(table, rec_reps, histories[:n_ref], 10, chunk)
    compare_lists(np.asarray(ids)[:n_ref], np.asarray(vals)[:n_ref], ref_ids, ref_vals,
                  f64_scorer(table, rec_reps),
                  f"{tag} streamed recommend_batch(k=10), first {n_ref} of {len(users)} users")

    t_fit = timed(lambda: model.fit(train), repeats)
    t_eval = timed(lambda: evaluation.mrr_score(model, test), repeats)
    t_rec = timed(lambda: model.recommend_batch(histories, k=10), repeats)
    print(f"{tag} time XLA path at {num_items:,} items: fit {t_fit:.4f} s ({steps} epochs, "
          f"{model.history.examples_per_epoch} examples/epoch), mrr_score {t_eval:.4f} s "
          f"({len(users)} users; first call {eval_first:.4f} s), recommend_batch {t_rec:.4f} s "
          f"({len(users)} users) (median of {repeats}) | {card}")
    return ids


def phase_streamed(card: str, seed: int):
    import sbr_rs_tpu as sbr

    n = 10_000_000
    train = sbr.datasets.synthetic_interactions(2048, n, 50, rng=seed).to_compressed()
    test = sbr.datasets.synthetic_interactions(512, n, 20, rng=seed + 1).to_compressed()
    print(f"[d] data: synthetic {n:,} items; train 2048 users x 50 events, eval 512 users x 20")
    model = _large_model(n, 3, seed)
    streamed_checks(card, "[d]", model, n, train, test, 64, 1 << 20)


# -- phase e ---------------------------------------------------------------------


def phase_parity(devices, big_items=1_100_000):
    """The 1.1M-item program of the multi-device dry run on a (data=2,
    model=2) mesh against one card, same seed, both on the scan tower (the
    tower a mesh runs)."""
    import jax

    from sbr_rs_tpu import evaluation
    from sbr_rs_tpu.data import Interactions
    from sbr_rs_tpu.models import Loss, Optimizer, lstm
    from sbr_rs_tpu.parallel import make_mesh

    rng = np.random.default_rng(1)
    big = Interactions.from_arrays(
        np.repeat(np.arange(96), 12), rng.integers(0, big_items, 96 * 12),
        np.tile(np.arange(12), 96), 96, big_items,
    ).to_compressed()

    def big_hyper():
        return (
            lstm.Hyperparameters(big_items, 8).embedding_dim(8).learning_rate(0.1)
            .loss(Loss.WARP).optimizer(Optimizer.ADAGRAD).num_epochs(1)
            .batch_size(16).from_seed(7)
        )

    mesh = make_mesh(data=2, model=2, devices=devices)
    sharded = big_hyper().mesh(mesh).build()
    single = _scan_lstm()(big_hyper())
    l_s, l_1 = sharded.fit(big), single.fit(big)
    check(abs(l_s - l_1) < 1e-3 * max(1.0, abs(l_1)),
          f"[e] parity (data=2, model=2) vs one card at {big_items:,} items: loss "
          f"{l_s:.6f} vs {l_1:.6f}, |diff| {abs(l_s - l_1):.3e} (tolerance 1e-3 x max(1, |loss|))")
    m_s, m_1 = evaluation.mrr_score(sharded, big), evaluation.mrr_score(single, big)
    check(abs(m_s - m_1) < 1e-6 + 1e-3 * m_1,
          f"[e] parity MRR {m_s:.8f} vs {m_1:.8f}, |diff| {abs(m_s - m_1):.3e} "
          f"(tolerance 1e-6 + 1e-3 x MRR)")
    drift = max(
        float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
        for a, b in zip(jax.tree_util.tree_leaves(sharded._params),
                        jax.tree_util.tree_leaves(single._params))
    )
    print(f"[e] parity: trained parameters differ by at most {drift:.3e} (the mesh "
          f"partitions the gradient sums, so they are summed in another order)")
    hist = [list(u.item_ids) for u in big.iter_users()]
    r_s = np.asarray(sharded.recommend_batch(hist, k=10))
    r_1 = np.asarray(single.recommend_batch(hist, k=10))
    same = int(np.sum(np.all(r_s == r_1, axis=1)))
    check(same == len(hist),
          f"[e] parity top-10 lists of the two trained models (both on the scan "
          f"tower): {same}/{len(hist)} identical (tolerance: all)")
    # The sharded serving and eval programs against the one-card programs
    # on the SAME parameters: lists and ranks must be identical.
    on_card = _scan_lstm()(big_hyper())
    on_card._params = jax.tree_util.tree_map(
        lambda a: jax.device_put(np.asarray(a), devices[0]), sharded._params)
    r_1 = np.asarray(on_card.recommend_batch(hist, k=10))
    same = int(np.sum(np.all(r_s == r_1, axis=1)))
    check(same == len(hist),
          f"[e] parity top-10 lists, sharded vs one-card programs on the same "
          f"parameters: {same}/{len(hist)} identical (tolerance: all)")
    k_s = evaluation._ranks_batched(sharded, big)
    k_1 = evaluation._ranks_batched(on_card, big)
    check(bool(np.array_equal(k_s, k_1)),
          f"[e] parity ranks, sharded vs one-card programs on the same parameters: "
          f"{int(np.sum(k_s == k_1))}/{len(k_1)} identical (tolerance: all)")


def phase_cards(card: str, seed: int, n=100_000_000):
    import jax

    import sbr_rs_tpu as sbr
    from sbr_rs_tpu.parallel import make_mesh

    devices = jax.devices()[:4]
    phase_parity(devices)

    # Scale: 100M items x dim 127 f32 with Adagrad state, row-sharded over
    # four cards (model=4); about 26 GB of table and state per card.
    train = sbr.datasets.synthetic_interactions(1024, n, 50, rng=seed).to_compressed()
    test = sbr.datasets.synthetic_interactions(512, n, 20, rng=seed + 1).to_compressed()
    print(f"[e] data: synthetic {n:,} items; train 1024 users x 50 events, eval 512 users x 20")
    mesh4 = make_mesh(data=1, model=4, devices=devices)
    model = _large_model(n, 2, seed, mesh=mesh4)
    print(f"[e] item table {model._params['item_table'].shape} sharding "
          f"{model._params['item_table'].sharding.spec}", flush=True)
    streamed_checks(card, "[e]", model, n, train, test, 64, 1 << 20, repeats=1)
    for d in devices:
        stats = d.memory_stats() or {}
        print(f"[e] peak memory {d}: {stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB "
              f"of {stats.get('bytes_limit', 0) / 2**30:.3f} GiB | {card}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1,
                        help="4 runs only the four-card phase e")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    card = phase_device(args.cards)

    import jax

    from sbr_rs_tpu.utils.compile_cache import enable_compile_cache

    print(f"[a] compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_cards(card, args.seed)
    else:
        phase_precision(card)
        phase_kernel(card, args.seed)
        phase_main(card, args.seed)
        phase_streamed(card, args.seed)
    print(f"total {time.perf_counter() - t0:.1f} s | {card}")
    if _FAILED:
        print(f"chip_smoke: {len(_FAILED)} check(s) failed:", file=sys.stderr)
        for f in _FAILED:
            print(f"  {f}", file=sys.stderr)
        sys.exit(1)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
