'''End-to-end A/B of the sorted-window half-pass implementations on one
GPU: the Pallas kernel (``ops.pallas_half_pass``) against the plain XLA
window sweeps, through the public training entry points at the
MovieLens-10M shape (69,878 x 10,677, 10M unique planted ratings,
rank 64):

  * ``GDRecommender.train(handle_bias=True)`` — shipped defaults, T=128,
  * ``KMFRecommender.train()`` — logistic link, T=64,
  * ``GDRecommender.feature_training_implicit()`` — SVD++, T=32.

Each arm's marginal epoch is a difference quotient of two train() calls
((t[1+span] - t[1]) / span), so compile, layout build and per-train set-up
cancel out.  Arms alternate kernel, xla, kernel in one process.  A last
section times the kernel alone on the GD half-passes for a few tile /
warp settings.  Prints one JSON line per measurement (with the device and
nvidia-smi's name and power limit), also appended to the file named by
AB_OUT when it is set.

    AB_OUT=ab_half_pass.jsonl python tools/ab_half_pass.py   # AB_SPAN=2
'''
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

import bench
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.models.kmf import KMFRecommender
from mfrec_tpu.ops import fn as fn_ops
from mfrec_tpu.ops import pallas_half_pass, sgd_mf
from mfrec_tpu.utils.compile_cache import enable_compile_cache

U, I, N, K = 69878, 10677, 10_000_000, 64
OUT = os.environ.get('AB_OUT')


def smi():
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except OSError as e:
        return repr(e)


def emit(rec):
    rec = dict(rec, device=jax.devices()[0].device_kind, smi=SMI)
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, 'a') as f:
            f.write(line + '\n')


def set_impl(kernel):
    '''Select the half-pass implementation the epoch builders bake in.'''
    sgd_mf.half_pass_kernel_default = (lambda: True) if kernel else \
        (lambda: False)
    for builder in (sgd_mf.make_alternating_epoch,
                    sgd_mf.make_alternating_implicit_epoch,
                    fn_ops.make_fn_alternating_epoch):
        builder.cache_clear()


def marginal(model, train, span):
    def timed(epochs):
        for attr in ('min_epochs', 'max_epochs', 'nbr_epochs'):
            if hasattr(model, attr):
                setattr(model, attr, epochs)
        t0 = time.perf_counter()
        train()
        return time.perf_counter() - t0, float(model.rmse_history[-1])
    t_warm, _ = timed(1)
    t_s, _ = timed(1)
    t_l, rmse = timed(1 + span)
    return (t_l - t_s) / span, t_warm, rmse


def main():
    global SMI
    SMI = smi()
    enable_compile_cache()
    span = int(os.environ.get('AB_SPAN', 2))
    users, items, vals = bench.make_data_unique(U, I, N)
    floor, _, _ = bench.bias_floor_rmse(users, items, vals, U, I)

    gd = GDRecommender(U, I, {'nbr_features': K, 'feature_init': 0.05,
                              'regularization_model': 0.02,
                              'min_improvement': -1.0,
                              'engine': 'alternating'})
    gd.set_ratings(users, items, vals)
    kmf = KMFRecommender(U, I, {'nbr_features': K, 'engine': 'alternating'})
    kmf.set_ratings(users, items, vals)
    svd = GDRecommender(U, I, {'nbr_features': K, 'feature_init': 0.05,
                               'regularization_model': 0.02,
                               'min_improvement': -1.0,
                               'engine': 'alternating'})
    svd.set_ratings(users, items, vals)
    configs = [
        ('gd_T128', gd, lambda: gd.train(handle_bias=True)),
        ('kmf_T64', kmf, lambda: kmf.train()),
        ('svdpp_T32', svd, lambda: svd.feature_training_implicit()),
    ]
    for name, model, train in configs:
        for kernel in (True, False, True):
            set_impl(kernel)
            ep, warm, rmse = marginal(model, train, span)
            emit({'config': name, 'impl': 'kernel' if kernel else 'xla',
                  'epoch_s': ep, 'first_train_s': warm,
                  'final_train_rmse': rmse, 'bias_floor_rmse': floor,
                  'nnz': int(model.ratings.nnz)})

    # kernel alone on the GD half-passes, per tile / warp setting
    set_impl(True)
    p_layout, q_layout, W_user, W_item = gd._alternating_layouts(128)
    st = gd._state(with_bias=True)
    Paug, Qaug = sgd_mf.augment_factors(
        jnp.pad(st.P, ((0, W_user), (0, 0))),
        jnp.pad(st.Q, ((0, W_item), (0, 0))),
        jnp.pad(st.bu, (0, W_user)), jnp.pad(st.bi, (0, W_item)))
    Pb, Qb = Paug.astype(jnp.bfloat16), Qaug.astype(jnp.bfloat16)
    for side, (F_upd, F_fix, lay, W, upd_user) in {
            'user': (Paug, Qb, p_layout, W_user, True),
            'item': (Qaug, Pb, q_layout, W_item, False)}.items():
        u, i, r, m, kl, lo = lay
        fix = i if upd_user else u
        lrv, regv = sgd_mf.col_vectors(K, upd_user, 0.15, 0.02)
        for tile, warps in ((32, 2), (64, 4), (128, 4), (128, 8),
                            (256, 8)):
            def run():
                return pallas_half_pass.half_pass(
                    F_upd, F_fix, fix, r, m, kl, lo, lrv, regv, st.mu,
                    W=W, inner_steps=128, tile=tile, num_warps=warps)
            try:
                jax.block_until_ready(run())
                t0 = time.perf_counter()
                for _ in range(3):
                    out = run()
                jax.block_until_ready(out)
                emit({'half_pass': side, 'tile': tile, 'num_warps': warps,
                      'seconds': (time.perf_counter() - t0) / 3})
            except Exception as e:          # a setting may not compile
                emit({'half_pass': side, 'tile': tile, 'num_warps': warps,
                      'error': repr(e)[:300]})


if __name__ == '__main__':
    main()
