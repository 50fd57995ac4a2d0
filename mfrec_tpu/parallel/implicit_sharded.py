'''
Multi-chip SVD++ — the windowed implicit tier over a device mesh.

The single-chip implicit epoch (``ops.sgd_mf.make_alternating_implicit_
epoch``) is five scatter-free window phases.  Sharded, every phase is
embarrassingly parallel in the side it writes:

  1. A[u] = nrm_u * sum_{j in R(u)} Y_j   — user rows; needs Y all_gather
  2. P half-pass on Peff = Paug + A       — user rows; needs Q all_gather
  3. Q half-pass vs updated Peff          — item rows; needs P all_gather
  4. G[u] = nrm_u * sum_i err_ui q_i      — user rows; reuses gathered Q
  5. y_j += lr_y (mean_u G[u] - K_y y_j)  — item rows; needs G all_gather

Users/items are range-partitioned exactly like the plain sharded
alternating engine (``parallel.alternating_sharded``): each shard is
padded by W rows so window updates never cross shards, and gather
indices into all-gathered arrays are padded-global ids.  Communication
per epoch = 4 all_gathers (Y, Q, Peff, G).

Reference seed: ``gd_estimator.pyx:785-898`` (the loop the reference
intended; its serial version is defective — SURVEY.md §2.6).
'''
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops.sgd_mf import clamp, col_vectors
from mfrec_tpu.parallel.alternating_sharded import sharded_half_pass
# single source of truth for the one-hot matmul window-aggregation numerics
# (bf16 operands, f32 accumulation, cnt clamp) — a fix there must apply
# to the sharded SVD++ epoch too, so no local copy
from mfrec_tpu.ops.sgd_mf import _agg_window as _chunked_agg


def make_sharded_implicit_epoch(mesh, W, lr, lr_y, K, K_y, clamp_pred=True,
                                lo_r=1.0, hi_r=5.0, chunk=4096,
                                row_mean=True, axis='dp', inner_steps=1):
    '''Jitted multi-chip SVD++ epoch:

        (Paug, Qaug, Ypad, mu, nrm, p_layout..., q_layout...)
            -> (Paug, Qaug, Ypad, rmse)

    Paug [D*(Ushard+W), k+2] row-sharded, Qaug/Ypad [D*(Ishard+W), ...]
    row-sharded, nrm [D*(Ushard+W)] per-user |N(u)|^-1/2 row-sharded;
    layouts from ``alternating_sharded.build_sharded_alternating_layout``
    (kl, other_padded_global, r, mask, lo per side).  Fixed-bias mode:
    biases ride the augmented columns.
    '''

    def strip(kl, og, rb, mb, lo):
        kl, og, rb, mb = (x.reshape(x.shape[-2:]) for x in
                          (kl, og, rb, mb))
        return kl, og, rb, mb, lo.reshape(lo.shape[-1:])

    def half_pass(F_upd, F_full, mu, kl, og, rb, mb, lo, upd_is_user):
        '''Fixed-bias sorted-window half-pass (local rows only): the
        bias/const columns ride a per-column lr of 0.'''
        lrv, regv = col_vectors(F_upd.shape[1] - 2, upd_is_user, lr, K)
        return sharded_half_pass(
            F_upd, F_full, mu, (kl, og, rb, mb, lo), lrv, regv, W=W,
            chunk=chunk, row_mean=row_mean, clamp_pred=clamp_pred,
            lo_r=lo_r, hi_r=hi_r, inner_steps=inner_steps)

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

    def device_fn(Paug, Qaug, Ypad, mu, nrm,
                  pkl, pog, prb, pmb, plo, qkl, qog, qrb, qmb, qlo):
        k = Ypad.shape[1]
        p_layout = strip(pkl, pog, prb, pmb, plo)
        q_layout = strip(qkl, qog, qrb, qmb, qlo)
        # 1) user aggregates of Y (sum over rated items, then * nrm)
        Y_full = jax.lax.all_gather(Ypad, axis, tiled=True)
        A = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        A = accumulate(A, p_layout,
                       lambda kli, ogi, r, m, lo_b: Y_full[ogi],
                       mean=False)
        A = A * nrm[:, None]
        Apad = jnp.pad(A, ((0, 0), (0, 2)))      # zero bias/const cols
        # 2+3) alternating half-passes on the effective factors
        Peff = Paug + Apad
        Q_full = jax.lax.all_gather(Qaug, axis, tiled=True)
        Peff, sse_p = half_pass(Peff, Q_full, mu, *p_layout, True)
        P_full = jax.lax.all_gather(Peff, axis, tiled=True)
        Qaug, sse_q = half_pass(Qaug, P_full, mu, *q_layout, False)
        Paug = Peff - Apad
        # 4) error-weighted item-factor sums into user windows
        Q_full = jax.lax.all_gather(Qaug, axis, tiled=True)

        def err_q(kli, ogi, r, m, lo_b):
            win = jax.lax.dynamic_slice_in_dim(Peff, lo_b, W, 0)
            fu = win[kli]
            ff = Q_full[ogi]
            pred = mu + (fu * ff).sum(-1)
            if clamp_pred:
                pred = clamp(pred, lo_r, hi_r)
            err = (r - pred) * m
            return err[:, None] * ff[:, :k]

        G = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        G = accumulate(G, p_layout, err_q, mean=False)
        G = G * nrm[:, None]
        # 5) aggregate G into item windows over the item-sorted stream
        G_full = jax.lax.all_gather(G, axis, tiled=True)

        def y_step(Y, batch):
            kli, ogi, r, m, lo_b = batch
            win = jax.lax.dynamic_slice_in_dim(Y, lo_b, W, 0)
            vals = G_full[ogi] - K_y * win[kli]
            gsum = _chunked_agg(vals, kli, m, W, chunk, row_mean)
            win = win + lr_y * gsum
            return jax.lax.dynamic_update_slice_in_dim(Y, win, lo_b, 0), \
                None

        Ypad, _ = jax.lax.scan(y_step, Ypad, q_layout)
        total = jax.lax.psum(sse_p + sse_q, axis)
        n = jax.lax.psum(pmb.sum() + qmb.sum(), axis)
        return Paug, Qaug, Ypad, jnp.sqrt(total / jnp.maximum(n, 1.0))

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PS(axis), PS(axis), PS(axis), PS(), PS(axis))
        + (PS(axis),) * 10,
        out_specs=(PS(axis), PS(axis), PS(axis), PS()),
        check_vma=False)
    return jax.jit(sharded)
