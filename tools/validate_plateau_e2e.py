'''End-to-end on-device validation of the SHIPPED stall-triggered
``lr_plateau_decay`` at the ML-10M headline shape.

Earlier time-to-quality probes validated plateau-onset decay with an
*epoch-indexed* schedule driven at the ops level.  This script drives the shipped mechanism instead — the
full model path: ``GDRecommender(... lr_plateau_decay=0.9).train(
handle_bias=True)`` with BellKor fixed biases, ConvergenceDriver decay
triggered by the measured improvement rule — and checks it reproduces
the probe's qualitative result end to end.

The check is INTERNALLY CONTROLLED and drift-immune: with
``plateau_decay=g``, every epoch before the first stall runs at
lr_scale=1.0, so the constant-rate run's trajectory is a bit-identical
PREFIX of this run's.  Replaying the recorded ``rmse_history`` through a
plain ConvergenceDriver therefore yields exactly where the constant run
would have stopped and at what RMSE — one run gives both arms.

Asserts:
  1. decay extended training past the constant stop point,
  2. final RMSE beats the constant run's stopping RMSE by > 1e-3
     (the probe margin at this shape is ~2e-3: full_train stops at
      ~0.290 while the decayed trajectory reaches the 0.2886 band).

Run from the repo root on the GPU: ``python tools/validate_plateau_e2e.py``.
'''
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

import bench
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.engine.trainer import ConvergenceDriver

U, I, N = 69878, 10677, 10_000_000
MIN_EPOCHS, MAX_EPOCHS, MIN_IMPROVEMENT = 3, 200, 1e-4


def model_vs_ops_control(model, blocks=2, span=3):
    '''Interleaved model-vs-ops epoch-time control arm (one-shot
    model-path timings drift; every e2e drive carries drift-immune epoch
    evidence).  Reuses the model's
    OWN cached layouts and the memo-identical epoch program, so the only
    difference is the driver loop + per-epoch host sync.  Returns
    (model_epoch_s, ops_epoch_s, ratio) medians.'''
    import jax
    import jax.numpy as jnp
    from mfrec_tpu.ops import sgd_mf
    mw = min(128, max(model.nbr_users, model.nbr_items))
    p_layout, q_layout, W_user, W_item = model._alternating_layouts(mw)
    lr, lr_bu, lr_bi = model._alt_lrs()
    ep = sgd_mf.make_alternating_epoch(
        W_user, W_item, lr, model.K, lr_bu=lr_bu, lr_bi=lr_bi,
        K_bu=model.K2, K_bi=model.K3, bias_mode='fixed',
        lo_r=model.min_rating, hi_r=model.max_rating,
        chunk=model.batch_size, inner_steps=model.inner_steps,
        ff_dtype='bfloat16')
    state = model._state(with_bias=True)
    Paug, Qaug = sgd_mf.augment_factors(
        jnp.pad(state.P, ((0, W_user), (0, 0))),
        jnp.pad(state.Q, ((0, W_item), (0, 0))),
        jnp.pad(state.bu, (0, W_user)),
        jnp.pad(state.bi, (0, W_item)))
    P_host, Q_host = np.array(Paug), np.array(Qaug)
    del Paug, Qaug
    mu = state.mu

    def ops_timed(epochs):
        Pa, Qa = jax.device_put(P_host), jax.device_put(Q_host)
        jax.block_until_ready((Pa, Qa))
        t0 = time.perf_counter()
        rmse = None
        for _ in range(epochs):
            Pa, Qa, rmse = ep(Pa, Qa, mu, p_layout, q_layout)
        jax.block_until_ready((Pa, Qa, rmse))
        return time.perf_counter() - t0

    def train_timed(epochs):
        me, mx, mi = model.min_epochs, model.max_epochs, \
            model.min_improvement
        pl = model.lr_plateau_decay
        model.min_epochs = model.max_epochs = epochs
        model.min_improvement = -1.0
        model.lr_plateau_decay = 1.0
        t0 = time.perf_counter()
        model.train(handle_bias=True)
        dt = time.perf_counter() - t0
        model.min_epochs, model.max_epochs, model.min_improvement = \
            me, mx, mi
        model.lr_plateau_decay = pl
        return dt

    _ = ops_timed(1)                       # memo-hit warm check
    marg, ops = [], []
    for _ in range(blocks):
        ops.append(ops_timed(span) / span)
        t_s = train_timed(1)
        t_l = train_timed(1 + span)
        marg.append((t_l - t_s) / span)
    m, o = float(np.median(marg)), float(np.median(ops))
    return m, o, m / o


def main():
    t0 = time.perf_counter()
    users, items, vals = bench.make_data(U, I, N, seed=0)
    t_data = time.perf_counter() - t0

    model = GDRecommender(U, I, {
        'nbr_features': 64,
        'feature_init': 0.05,
        'min_epochs': MIN_EPOCHS,
        'max_epochs': MAX_EPOCHS,
        'min_improvement': MIN_IMPROVEMENT,
        'regularization_model': 0.02,
        'regularization_users_bias': 0.02,
        'regularization_items_bias': 0.02,
        # the documented ML-10M deep-plateau recipe (README):
        # inner_steps=64 + plateau decay; learning_rate stays unset so
        # the row-mean 0.15 default (the benchmarked rate) applies
        'inner_steps': 64,
        'lr_plateau_decay': 0.9,
        'engine': 'alternating',
    })
    model.set_ratings(users.astype(np.int32), items.astype(np.int32),
                      vals.astype(np.float32))
    t1 = time.perf_counter()
    model.train(handle_bias=True)
    t_train = time.perf_counter() - t1

    history = [float(r) for r in model.rmse_history]
    final = history[-1]

    # Replay the history through a plain (plateau_decay=1.0) driver: the
    # decay run's pre-stall prefix is identical to the constant run, so
    # this recovers the constant run's stop epoch + stopping RMSE exactly.
    replay = iter(history)
    ref = ConvergenceDriver(MIN_EPOCHS, MAX_EPOCHS, MIN_IMPROVEMENT)
    try:
        ref.run(lambda s: (s, next(replay)), None)
        exhausted = False
    except StopIteration:
        exhausted = True
    constant_epochs = len(ref.history)
    constant_final = ref.history[-1] if ref.history else float('nan')

    ok_extended = (not exhausted) and len(history) > constant_epochs
    ok_quality = np.isfinite(final) and final < constant_final - 1e-3
    # drift-immune epoch-time control: interleaved
    # model-vs-ops blocks with caches warm; a model-layer regression like
    # the r4 "6.4 s epochs" shows up as ratio >> 1 here, not as a
    # one-shot wall-clock anecdote
    if os.environ.get('E2E_OPS_CONTROL', '1') == '1':
        m_ep, o_ep, ratio = model_vs_ops_control(model)
    else:
        m_ep = o_ep = ratio = None
    print(json.dumps({
        'metric': 'ml10m_rank64_plateau_decay_e2e',
        'epochs': len(history),
        'train_s': round(t_train, 1),
        'data_prep_s': round(t_data, 1),
        'constant_stop_epochs': constant_epochs,
        'constant_stop_rmse': round(constant_final, 4),
        'final_rmse': round(final, 4),
        'margin': round(constant_final - final, 4),
        'decay_extended_training': bool(ok_extended),
        'beats_constant_stop_by_1e3': bool(ok_quality),
        'model_epoch_s': None if m_ep is None else round(m_ep, 4),
        'ops_epoch_s': None if o_ep is None else round(o_ep, 4),
        'model_vs_ops_ratio': None if ratio is None else round(ratio, 3),
        'ok': bool(ok_extended and ok_quality),
    }))
    if not (ok_extended and ok_quality):
        sys.exit(1)


if __name__ == '__main__':
    main()
