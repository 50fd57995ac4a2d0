'''Interleaved MODEL-path vs OPS-path A/B at the ML-10M headline shape.

Measures the gap between ``GDRecommender.train()`` and the raw epoch
program it runs: alternating timed blocks of the two paths in ONE
process.

  * ops arm    — raw epochs of the EXACT epoch program the model builds
                 (the memoized ``sgd_mf.make_alternating_epoch`` returns
                 the same jitted function object for the same config),
                 driven with the model's own cached layouts.
  * model arm  — ``train(handle_bias=True)`` timed at two epoch counts;
                 the marginal epoch is the difference quotient, so every
                 per-train fixed cost (factor init, BellKor biases,
                 layout-cache probe, driver setup) cancels out of it and
                 is reported separately as ``fixed_s``.

Run from the repo root on the GPU: ``python tools/ab_model.py``.
Env: AB_T (inner_steps, default 128), AB_BLOCKS (default 3),
AB_EPOCHS (marginal-epoch span, default 5).
'''
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

import bench
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.ops import sgd_mf

U, I, N = 69878, 10677, 10_000_000


def main():
    T = int(os.environ.get('AB_T', 128))
    blocks = int(os.environ.get('AB_BLOCKS', 3))
    span = int(os.environ.get('AB_EPOCHS', 5))
    e_short, e_long = 2, 2 + span

    print('--- model-vs-ops A/B: ML-10M rank 64, T=%d, %d blocks' %
          (T, blocks), flush=True)
    users, items, vals = bench.make_data(U, I, N, seed=0)
    model = GDRecommender(U, I, {
        'nbr_features': 64,
        'feature_init': 0.05,
        'regularization_model': 0.02,
        'inner_steps': T,
        'engine': 'alternating',
        'min_improvement': -1.0,      # epoch count pinned by min=max
    })
    model.set_ratings(users.astype(np.int32), items.astype(np.int32),
                      vals.astype(np.float32))

    def train_timed(epochs):
        model.min_epochs = epochs
        model.max_epochs = epochs
        t0 = time.perf_counter()
        model.train(handle_bias=True)
        return time.perf_counter() - t0, model.rmse_history[-1]

    # Warmup: pays data consolidation + layout build + compile ONCE;
    # with the epoch-builder memo + layout cache every later
    # train() reuses both (this is itself one of the things under test —
    # a recompile would show up as an absurd fixed_s).
    t_warm, _ = train_timed(1)
    print('warmup train(1): %.1f s (compile + layout build)' % t_warm,
          flush=True)

    # ops arm: the model's own layouts + the memo-identical epoch program
    mw = min(128, max(U, I))
    p_layout, q_layout, W_user, W_item = model._alternating_layouts(mw)
    lr, lr_bu, lr_bi = model._alt_lrs()
    ep = sgd_mf.make_alternating_epoch(
        W_user, W_item, lr, model.K, lr_bu=lr_bu, lr_bi=lr_bi,
        K_bu=model.K2, K_bi=model.K3, bias_mode='fixed',
        lo_r=model.min_rating, hi_r=model.max_rating,
        chunk=model.batch_size, inner_steps=T, ff_dtype='bfloat16')
    state = model._state(with_bias=True)
    Paug0, Qaug0 = sgd_mf.augment_factors(
        jnp.pad(state.P, ((0, W_user), (0, 0))),
        jnp.pad(state.Q, ((0, W_item), (0, 0))),
        jnp.pad(state.bu, (0, W_user)),
        jnp.pad(state.bi, (0, W_item)))
    mu = state.mu
    # the model's epoch donates its factor args, so each timed run gets a
    # fresh device upload (outside the timed region, synced before t0)
    P_host, Q_host = np.array(Paug0), np.array(Qaug0)
    del Paug0, Qaug0

    def ops_timed(epochs):
        Pa = jax.device_put(P_host)
        Qa = jax.device_put(Q_host)
        jax.block_until_ready((Pa, Qa))         # upload done before t0
        t0 = time.perf_counter()
        rmse = None
        for _ in range(epochs):
            Pa, Qa, rmse = ep(Pa, Qa, mu, p_layout, q_layout)
        jax.block_until_ready((Pa, Qa, rmse))
        r = float(rmse)
        return time.perf_counter() - t0, r

    # compile check for the ops arm (should be a cache hit: same program)
    t0 = time.perf_counter()
    _, r = ops_timed(1)
    print('ops warm epoch: %.2f s (memo hit expected: no recompile)'
          % (time.perf_counter() - t0), flush=True)

    ops, marg, fixed = [], [], []
    rmse_m = rmse_o = None
    for b in range(blocks):
        t_o, rmse_o = ops_timed(span)
        ops.append(t_o / span)
        t_s, _ = train_timed(e_short)
        t_l, rmse_m = train_timed(e_long)
        m_ep = (t_l - t_s) / (e_long - e_short)
        marg.append(m_ep)
        fixed.append(t_s - e_short * m_ep)
        print('block %d: ops %.4f  model-marginal %.4f  fixed %.2f s'
              % (b, ops[-1], m_ep, fixed[-1]), flush=True)

    med_o, med_m = float(np.median(ops)), float(np.median(marg))
    print('ops epoch median    : %.4f s  (rmse@%d %.4f)'
          % (med_o, span, rmse_o))
    print('model epoch median  : %.4f s  (rmse@%d %.4f)'
          % (med_m, e_long, rmse_m))
    print('model/ops ratio     : %.3f' % (med_m / med_o))
    print('per-train fixed cost: %.2f s median (layout+epoch caches warm)'
          % float(np.median(fixed)))


if __name__ == '__main__':
    main()
