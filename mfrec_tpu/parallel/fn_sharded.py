'''
Multi-chip FN (Koren KDD'08 §4) — the factorized-neighborhood tier over
a device mesh.  BEYOND the reference: it never implements FN at all
(``mfrec/recommendation/fn.py:75,90``).

The single-chip FN epoch (``ops.fn.make_fn_alternating_epoch``) is six
scatter-free window phases; sharded, each is embarrassingly parallel in
the side it writes, exactly like the SVD++ tier
(``parallel.implicit_sharded``):

  1. A[u] = nrm_u * sum_j [resid_uj x_j + y_j]  — user rows; needs
     X/Y/bi all_gathers (bi rides the gathered Qaug columns)
  2. install A into the user factor columns (profiles are DERIVED)
  3. user half-pass, factor columns frozen (b_u only) — needs Q_full
  4. item half-pass (q_i, b_i)                  — needs P_full
  5. G[u] = nrm_u * sum_i err_ui q_i            — user rows; reuses the
     gathered Qaug
  6. x_j / y_j window steps from G              — item rows; needs
     G + bu all_gathers

Users/items are range-partitioned like the plain sharded alternating
engine; each shard is padded by W rows so window updates never cross
shards, and gather indices into all-gathered arrays are padded-global
ids.  Communication per epoch = 5 all_gathers (X, Y, Qaug, Paug,
G+bu).
'''
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops.sgd_mf import clamp, col_vectors
from mfrec_tpu.ops.sgd_mf import _agg_window as _chunked_agg
from mfrec_tpu.parallel.alternating_sharded import sharded_half_pass


def make_sharded_fn_epoch(mesh, W, lr, lr_bu, lr_bi, lr_xy, K, K_bu,
                          K_bi, K_x=None, K_y=None, clamp_pred=True,
                          lo_r=1.0, hi_r=5.0, chunk=4096, row_mean=True,
                          axis='dp', inner_steps=1):
    '''Jitted multi-chip FN epoch:

        (Paug, Qaug, Xpad, Ypad, mu, nrm, p_layout..., q_layout...)
            -> (Paug, Qaug, Xpad, Ypad, rmse)

    Paug [D*(Ushard+W), k+2] row-sharded (factor columns hold the
    installed profiles, column k the learned b_u); Qaug/Xpad/Ypad
    [D*(Ishard+W), ...] row-sharded; nrm [D*(Ushard+W)] per-user
    |R(u)|^-1/2 row-sharded; layouts from
    ``alternating_sharded.build_sharded_alternating_layout``.
    '''
    K_x = K if K_x is None else K_x
    K_y = K if K_y is None else K_y

    def strip(kl, og, rb, mb, lo):
        kl, og, rb, mb = (x.reshape(x.shape[-2:]) for x in
                          (kl, og, rb, mb))
        return kl, og, rb, mb, lo.reshape(lo.shape[-1:])

    def accumulate(target, layout, source_fn, mean):
        '''Accumulate source_fn(batch) rows into local `target` windows.'''
        def step(tgt, batch):
            kli, ogi, r, m, lo_b = batch
            vals = source_fn(kli, ogi, r, m, lo_b)
            gsum = _chunked_agg(vals, kli, m, W, chunk, mean)
            win = jax.lax.dynamic_slice_in_dim(tgt, lo_b, W, 0)
            return jax.lax.dynamic_update_slice_in_dim(
                tgt, win + gsum, lo_b, 0), None
        tgt, _ = jax.lax.scan(step, target, layout)
        return tgt

    def device_fn(Paug, Qaug, Xpad, Ypad, mu, nrm,
                  pkl, pog, prb, pmb, plo, qkl, qog, qrb, qmb, qlo):
        k = Xpad.shape[1]
        p_layout = strip(pkl, pog, prb, pmb, plo)
        q_layout = strip(qkl, qog, qrb, qmb, qlo)
        X_full = jax.lax.all_gather(Xpad, axis, tiled=True)
        Y_full = jax.lax.all_gather(Ypad, axis, tiled=True)
        Q_full = jax.lax.all_gather(Qaug, axis, tiled=True)
        bu_loc = Paug[:, k]
        bi_full = Q_full[:, k + 1]

        # 1) profiles: A[u] = nrm_u * sum_j [resid_uj x_j + y_j]
        def xy_src(kli, ogi, r, m, lo_b):
            bu_b = jax.lax.dynamic_slice_in_dim(bu_loc, lo_b, W, 0)[kli]
            resid = r - (mu + bu_b + bi_full[ogi])
            return resid[:, None] * X_full[ogi] + Y_full[ogi]
        A = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        A = accumulate(A, p_layout, xy_src, mean=False)
        A = A * nrm[:, None]
        # 2) install: profiles are derived, not free parameters
        Paug = Paug.at[:, :k].set(A)

        # 3) user half-pass (b_u only) + 4) item half-pass (q, b_i)
        # user rows [a_u | bu | 1]: factor columns FROZEN (derived
        # profiles), only b_u trains; item rows [q | 1 | bi]: q + b_i
        lrv_u, regv_u = col_vectors(k, True, lr, K, lr_bu, K_bu,
                                    learned=True, freeze_factors=True)
        Paug, sse_p = sharded_half_pass(
            Paug, Q_full, mu, p_layout, lrv_u, regv_u, W=W, chunk=chunk,
            row_mean=row_mean, clamp_pred=clamp_pred, lo_r=lo_r,
            hi_r=hi_r, inner_steps=inner_steps)
        P_full = jax.lax.all_gather(Paug, axis, tiled=True)
        lrv_i, regv_i = col_vectors(k, False, lr, K, lr_bi, K_bi,
                                    learned=True)
        Qaug, sse_q = sharded_half_pass(
            Qaug, P_full, mu, q_layout, lrv_i, regv_i, W=W, chunk=chunk,
            row_mean=row_mean, clamp_pred=clamp_pred, lo_r=lo_r,
            hi_r=hi_r, inner_steps=inner_steps)

        # 5) G[u] = nrm_u * sum_i err_ui q_i (post-half-pass factors)
        Q_full2 = jax.lax.all_gather(Qaug, axis, tiled=True)

        def err_q(kli, ogi, r, m, lo_b):
            fu = jax.lax.dynamic_slice_in_dim(Paug, lo_b, W, 0)[kli]
            ff = Q_full2[ogi]
            pred = mu + (fu * ff).sum(-1)
            if clamp_pred:
                pred = clamp(pred, lo_r, hi_r)
            err = (r - pred) * m
            return err[:, None] * ff[:, :k]
        G = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        G = accumulate(G, p_layout, err_q, mean=False)
        G = G * nrm[:, None]
        G_full = jax.lax.all_gather(G, axis, tiled=True)
        bu_full = jax.lax.all_gather(Paug[:, k], axis, tiled=True)
        bi_loc = Qaug[:, k + 1]

        # 6) X/Y window steps over the ITEM-sorted stream (local shard)
        def xy_step(carry, batch):
            X, Y = carry
            kli, ogi, r, m, lo_b = batch
            winX = jax.lax.dynamic_slice_in_dim(X, lo_b, W, 0)
            winY = jax.lax.dynamic_slice_in_dim(Y, lo_b, W, 0)
            bi_b = jax.lax.dynamic_slice_in_dim(bi_loc, lo_b, W, 0)[kli]
            resid = r - (mu + bu_full[ogi] + bi_b)
            Gu = G_full[ogi]
            gX = resid[:, None] * Gu - K_x * winX[kli]
            gY = Gu - K_y * winY[kli]
            aggX = _chunked_agg(gX, kli, m, W, chunk, row_mean)
            aggY = _chunked_agg(gY, kli, m, W, chunk, row_mean)
            X = jax.lax.dynamic_update_slice_in_dim(
                X, winX + lr_xy * aggX, lo_b, 0)
            Y = jax.lax.dynamic_update_slice_in_dim(
                Y, winY + lr_xy * aggY, lo_b, 0)
            return (X, Y), None
        (Xpad, Ypad), _ = jax.lax.scan(xy_step, (Xpad, Ypad), q_layout)

        total = jax.lax.psum(sse_p + sse_q, axis)
        n = jax.lax.psum(pmb.sum() + qmb.sum(), axis)
        return (Paug, Qaug, Xpad, Ypad,
                jnp.sqrt(total / jnp.maximum(n, 1.0)))

    in_specs = (PS(axis), PS(axis), PS(axis), PS(axis), PS(),
                PS(axis)) + (PS(axis),) * 10
    out_specs = (PS(axis), PS(axis), PS(axis), PS(axis), PS())
    sharded = shard_map(device_fn, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, check_vma=False)
    return jax.jit(sharded, donate_argnums=(0, 1, 2, 3))
