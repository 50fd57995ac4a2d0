'''Interleaved T-ladder A/B for the FN alternating tier: alternating
timed blocks of two inner_steps configs in ONE process.

Run from the repo root on the GPU: ``python tools/ab_fn.py``.
Env: AB_T='32,64' (the two rungs), AB_BLOCKS (default 3),
AB_EPOCHS (epochs per block, default 3).
'''
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

import bench
from mfrec_tpu.ops import sgd_mf
from mfrec_tpu.ops import fn as fn_ops

U, I, N, K = 69878, 10677, 10_000_000, 64
W, BATCH = 512, 1 << 14


def build(T):
    ep = fn_ops.make_fn_alternating_epoch(
        W_user, W_item, lr=0.15, lr_bu=0.05, lr_bi=0.05, lr_xy=0.15,
        K=0.02, K_bu=0.02, K_bi=0.02, K_x=0.02, K_y=0.02,
        inner_steps=T, chunk=8192, donate=False)
    rng = np.random.default_rng(7)
    f = 0.05
    Paug, Qaug = sgd_mf.augment_factors(
        jnp.zeros((U + W_user, K), jnp.float32),
        jnp.asarray(rng.normal(0, f, (I + W_item, K)), jnp.float32),
        jnp.asarray(np.pad(bu_fit, (0, W_user))),
        jnp.asarray(np.pad(bi_fit, (0, W_item))))
    Xpad = jnp.asarray(rng.normal(0, f, (I + W_item, K)), jnp.float32)
    Ypad = jnp.asarray(rng.normal(0, f, (I + W_item, K)), jnp.float32)
    return ep, (Paug, Qaug, Xpad, Ypad)


def run_block(ep, st, epochs):
    Pa, Qa, Xp, Yp = st
    t0 = time.perf_counter()
    rmse = None
    for _ in range(epochs):
        Pa, Qa, Xp, Yp, rmse = ep(Pa, Qa, Xp, Yp, mu, p_layout, q_layout,
                                  nrm_rows)
    r = float(rmse)
    return (time.perf_counter() - t0) / epochs, (Pa, Qa, Xp, Yp), r


if __name__ == '__main__':
    Ta, Tb = (int(x) for x in os.environ.get('AB_T', '32,64').split(','))
    blocks = int(os.environ.get('AB_BLOCKS', 3))
    epochs = int(os.environ.get('AB_EPOCHS', 3))
    print('--- FN T ladder A/B: T=%d vs T=%d (%d blocks x %d epochs)'
          % (Ta, Tb, blocks, epochs), flush=True)
    users, items, vals = bench.make_data(U, I, N)
    floor, bu_fit, bi_fit = bench.bias_floor_rmse(users, items, vals, U, I)
    pl_ = sgd_mf.sorted_pass_layout(users, items, vals, BATCH, axis='user',
                                    max_window=W)
    ql_ = sgd_mf.sorted_pass_layout(users, items, vals, BATCH, axis='item',
                                    max_window=W)
    W_user, W_item = pl_[-1], ql_[-1]
    p_layout = tuple(jnp.asarray(x) for x in pl_[:-1])
    q_layout = tuple(jnp.asarray(x) for x in ql_[:-1])
    counts = np.bincount(users, minlength=U).astype(np.float32)
    nrm = np.zeros(U + W_user, np.float32)
    nrm[:U] = np.where(counts > 0,
                       1.0 / np.sqrt(np.maximum(counts, 1.0)), 0.0)
    nrm_rows = jnp.asarray(nrm)
    mu = jnp.float32(vals.mean())

    ep_a, st_a = build(Ta)
    ep_b, st_b = build(Tb)
    _, st_a, _ = run_block(ep_a, st_a, 1)      # compile
    _, st_b, _ = run_block(ep_b, st_b, 1)
    ta, tb = [], []
    ra = rb = None
    for _ in range(blocks):
        dt, st_a, ra = run_block(ep_a, st_a, epochs)
        ta.append(dt)
        dt, st_b, rb = run_block(ep_b, st_b, epochs)
        tb.append(dt)
    ma, mb = float(np.median(ta)), float(np.median(tb))
    print('T=%d: %s median %.4f s/epoch  rmse %.4f'
          % (Ta, [round(x, 4) for x in ta], ma, ra))
    print('T=%d: %s median %.4f s/epoch  rmse %.4f'
          % (Tb, [round(x, 4) for x in tb], mb, rb))
    print('rate ratio (Tb sweeps/s vs Ta): %.3f'
          % ((Tb / mb) / (Ta / ma)))
    print('floor %.4f' % floor)
