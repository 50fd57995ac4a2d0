#!/usr/bin/env python
'''
On-device smoke check: drives the system's main path once on one NVIDIA
GPU through the public entry points, at the full width of the headline
configuration (MovieLens-10M shape, rank 64), with data made from
``--seed``, and compares every device result with a float64 numpy (or
``highest``-precision) reference.

Phases, in one process:

  1. device       — refuse (exit 1) unless JAX's platform is ``gpu``;
                    print the device kind and nvidia-smi's name/power limit.
  2. half-pass    — one sorted-window batch at the default widths
                    (B=16384, W=128, k=64+2) through the Pallas kernel and
                    the XLA sweeps, T=1 and T=128, identity and logistic
                    links, against ``reference_numpy.window_half_pass``.
  3. train        — ``GDRecommender.train(handle_bias=True)`` at shipped
                    defaults (engine auto -> alternating, batch 16384,
                    T=128) for 3 epochs on 10M unique planted ratings;
                    final train RMSE must beat the bias-only floor.
  4. recommend    — ``recommend_batch`` top-10 for 1024 users (rated
                    masked) vs a float64 brute force, then an in-process
                    ``RecommenderServer`` on an ephemeral localhost port
                    whose /recommend answers must equal recommend_batch.
  5. wrmf         — ``WRMFRecommender.train()`` (ALS, solver='cg') on
                    planted implicit data; held-out P@5 must beat the
                    popularity floor.

``--four-cards`` runs only the multi-device path and what it is compared
with, over 4 GPUs: training through ``alternating_sharded`` vs
``engine='alternating'`` on one card, sharded vs single-card top-N, and
the sharded vs single-card ALS epoch.

The last stdout line is ``{"ok": true, "device": {...}}``; any failed
phase exits non-zero without it.

    python chip_smoke.py [--seed 0] [--four-cards]
'''
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# MovieLens-10M shape (BASELINE.md headline config)
U, I, N, RANK = 69878, 10677, 10_000_000, 64


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ 1. device
def phase_device(want_count):
    import jax
    devs = jax.devices()
    platform = devs[0].platform
    if platform != 'gpu':
        print('chip_smoke: JAX found no GPU (platform %r); nothing run'
              % platform, file=sys.stderr)
        sys.exit(1)
    if len(devs) < want_count:
        print('chip_smoke: need %d GPUs, found %d' % (want_count, len(devs)),
              file=sys.stderr)
        sys.exit(1)
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = 'nvidia-smi unavailable: %r' % (e,)
    log('device: %s x%d (%s)' % (devs[0].device_kind, len(devs), platform))
    log('nvidia-smi: %s' % smi.replace('\n', ' | '))
    return {'platform': platform, 'kind': devs[0].device_kind,
            'count': want_count}


# -------------------------------------------------------- 2. half-pass
def make_window_batch(rng, B=16384, W=128, k=RANK, n_fixed=I):
    '''One sorted-window batch at the default widths: heavy-tailed runs
    (one row holding several thousand slots, some rows empty), mask-0
    padding at the end, augmented [factors | bias | 1] rows.'''
    lens = np.floor(rng.pareto(1.2, W) * 40).astype(np.int64)
    lens[rng.integers(0, W)] = 3000
    lens[rng.random(W) < 0.05] = 0
    lens = np.minimum(lens, 6000)
    scale = (B - 500) / max(lens.sum(), 1)
    if scale < 1.0:
        lens = np.floor(lens * scale).astype(np.int64)
    kl_valid = np.repeat(np.arange(W), lens)
    nv = kl_valid.size
    kl = np.zeros(B, np.int32)
    kl[:nv] = kl_valid
    m = np.zeros(B, np.float32)
    m[:nv] = 1.0
    fix = rng.integers(0, n_fixed, B).astype(np.int32)
    F = rng.normal(0, 0.1, (n_fixed, k + 2)).astype(np.float32)
    F[:, k] = 1.0
    F[:, k + 1] = rng.normal(0, 0.3, n_fixed)
    win = rng.normal(0, 0.1, (W, k + 2)).astype(np.float32)
    win[:, k] = rng.normal(0, 0.3, W)
    win[:, k + 1] = 1.0
    r = np.clip(np.round(rng.normal(3.5, 1.0, B) * 2) / 2,
                1.0, 5.0).astype(np.float32)
    return win, F, fix, r, m, kl


def phase_half_pass(rng, T_list=(1, 128), interpret=False, **batch_kw):
    import jax
    import jax.numpy as jnp
    from mfrec_tpu.ops import sgd_mf
    from mfrec_tpu.ops.reference_numpy import window_half_pass as twin
    win, F, fix, r, m, kl = make_window_batch(rng, **batch_kw)
    W, kdim = win.shape
    k = kdim - 2
    lrv, regv = sgd_mf.col_vectors(k, True, 0.15, 0.02)
    Fb = jnp.asarray(F, jnp.bfloat16)             # the shipped fixed side
    F_rounded = np.asarray(Fb, np.float32)
    # one batch as a layout of nb=1 (window start 0)
    lay = tuple(jnp.asarray(x[None]) for x in (fix, r, m, kl)) \
        + (jnp.zeros((1,), jnp.int32),)
    log('half-pass batch: B=%d W=%d k=%d valid=%d heaviest run=%d'
        % (kl.size, W, kdim, int(m.sum()), int(np.bincount(
            kl[m > 0], minlength=W).max())))
    for link in ('identity', 'logistic'):
        for T in T_list:
            kw = dict(inner_steps=T, link=link,
                      clamp_pred=link == 'identity', lo_r=1.0, hi_r=5.0,
                      row_mean=True, bias_none=False)
            for impl, Fdev, Fref in (('kernel', Fb, F_rounded),
                                     ('xla', jnp.asarray(F), F)):
                got, sse = sgd_mf.sorted_half_pass(
                    jnp.asarray(win), Fdev, *lay, lrv, regv, 3.5, W=W,
                    chunk=kl.size, kernel=impl == 'kernel',
                    interpret=interpret, **kw)
                got = np.asarray(jax.block_until_ready(got))
                want, sse_want = twin(win, Fref[fix], r, m, kl,
                                      np.asarray(lrv), np.asarray(regv),
                                      3.5, **kw)
                err = float(np.abs(got - want).max())
                rel = err / float(np.abs(want).max())
                sse_rel = abs(float(sse) - sse_want) / max(sse_want, 1e-30)
                # kernel: float32 arithmetic vs the float64 twin on the
                # same bf16-rounded fixed rows; sums in another order,
                # compounded over T sweeps.  xla: additionally rounds each
                # slot's gradient to bfloat16 (relative 2^-9) before its
                # one-hot aggregation, every sweep.
                tol = (1e-4 if T == 1 else 1e-3) if impl == 'kernel' \
                    else (2e-3 if T == 1 else 5e-3)
                log('  %-8s %-6s T=%-3d max|err| %.3e  rel %.3e  '
                    'sse rel %.3e  (tol rel %.0e: %s)'
                    % (link, impl, T, err, rel, sse_rel, tol,
                       'f32 vs f64, reordered sums' if impl == 'kernel'
                       else 'bf16 gradient rounding'))
                check(np.isfinite(got).all(), 'non-finite half-pass output')
                check(rel <= tol, 'half-pass %s/%s/T=%d rel err %.3e > %.0e'
                      % (link, impl, T, rel, tol))
                check(sse_rel <= 1e-4, 'half-pass sse mismatch %.3e'
                      % sse_rel)
    log('phase half-pass: ok')


# ------------------------------------------------------------ 3. train
def make_model(users, items, vals, U_, I_, engine='auto', epochs=3):
    from mfrec_tpu.models.gd import GDRecommender
    model = GDRecommender(U_, I_, {
        'nbr_features': RANK,
        'feature_init': 0.05,
        'regularization_model': 0.02,
        'min_improvement': -1.0,          # epoch count pinned by min=max
        'min_epochs': epochs,
        'max_epochs': epochs,
        'engine': engine,
    })
    model.set_ratings(users, items, vals)
    return model


def make_ratings(seed, U_=U, I_=I, N_=N):
    import bench
    users, items, vals = bench.make_data_unique(U_, I_, N_, seed=seed)
    floor, _, _ = bench.bias_floor_rmse(users, items, vals, U_, I_)
    return users, items, vals, floor


def phase_train(seed, U_=U, I_=I, N_=N, engine='auto', label='train'):
    t0 = time.perf_counter()
    users, items, vals, floor = make_ratings(seed, U_, I_, N_)
    log('%s: data %d x %d, %d ratings, bias floor %.4f (%.1f s)'
        % (label, U_, I_, N_, floor, time.perf_counter() - t0))
    model = make_model(users, items, vals, U_, I_, engine=engine)
    from mfrec_tpu.engine import trainer
    epoch_times = []

    class Timed(trainer.ConvergenceDriver):
        def run(self, epoch_fn, state):
            import jax

            def timed(s):
                t1 = time.perf_counter()
                s, rmse = epoch_fn(s)
                jax.block_until_ready((s, rmse))
                epoch_times.append(time.perf_counter() - t1)
                return s, rmse
            return super().run(timed, state)

    from mfrec_tpu.models import gd
    real = gd.ConvergenceDriver
    gd.ConvergenceDriver = Timed
    try:
        model.train(handle_bias=True)
    finally:
        gd.ConvergenceDriver = real
    hist = [float(x) for x in model.rmse_history]
    log('%s: engine %s, nnz %d, epoch s %s (first includes compile; not a '
        'claim), train rmse %s'
        % (label, model.engine, model.ratings.nnz,
           ' '.join('%.3f' % t for t in epoch_times),
           ' '.join('%.4f' % h for h in hist)))
    check(model.ratings.nnz == N_, 'nnz %d != %d' % (model.ratings.nnz, N_))
    check(all(np.isfinite(hist)), 'non-finite train RMSE')
    check(hist[-1] < floor, 'final train RMSE %.4f does not beat the bias '
          'floor %.4f' % (hist[-1], floor))
    log('phase %s: ok' % label)
    return model, hist


# -------------------------------------------------------- 4. recommend
def brute_force_topn(model, users, n):
    '''float64 numpy reference of GDRecommender's default predictor
    (dot + 1) with rated items masked; also the per-score bound of TF32
    input rounding (10-bit mantissa: each operand within 2^-11 relative,
    so a product within ~2^-10 of |p||q|).'''
    P = np.asarray(model.P, np.float64)[users]
    Q = np.asarray(model.Q, np.float64)
    scores = P @ Q.T + 1.0
    bound = np.abs(P) @ np.abs(Q).T * 2.0 ** -10 + 1e-5
    ptr, rated, _ = model.ratings.csr()
    for row, u in enumerate(users):
        scores[row, rated[ptr[u]:ptr[u + 1]]] = -np.inf
    order = np.argsort(-scores, axis=1, kind='stable')[:, :n]
    return scores, bound, order


def compare_topn(ids, sc, scores, bound, order, n, label):
    rows = np.arange(ids.shape[0])[:, None]
    check(np.isfinite(sc).all(), '%s: non-finite scores' % label)
    ref_at = scores[rows, ids]
    check(np.isfinite(ref_at).all(), '%s: a rated item was recommended'
          % label)
    serr = np.abs(sc - ref_at)
    check((serr <= bound[rows, ids]).all(), '%s: score error %.3e beyond '
          'the TF32 bound' % (label, float(serr.max())))
    # a returned id may differ from the float64 top-n only inside a
    # near-tie: its exact score must reach the n-th exact score within
    # twice the rounding bound
    nth = scores[rows[:, 0], order[:, -1]]
    slack = 2 * bound.max(1)
    check((ref_at.min(1) >= nth - slack).all(), '%s: id outside the '
          'float64 top-%d beyond near-ties' % (label, n))
    overlap = np.mean([len(set(a) & set(b)) / n for a, b in zip(ids, order)])
    log('%s: max score err %.3e (bound: TF32 products), top-%d id overlap '
        'with float64 %.4f' % (label, float(serr.max()), n, overlap))
    return overlap


def phase_recommend(model, rng, n_users=1024, n=10, n_requests=8):
    import urllib.request
    from mfrec_tpu.serving import RecommenderServer
    users = np.sort(rng.choice(model.nbr_users, n_users, replace=False))
    ids, sc = model.recommend_batch(users, nbr_recommendations=n)
    ids, sc = np.asarray(ids), np.asarray(sc, np.float64)
    check(ids.shape == (n_users, n), 'recommend_batch shape %s'
          % (ids.shape,))
    scores, bound, order = brute_force_topn(model, users, n)
    compare_topn(ids, sc, scores, bound, order, n, 'recommend_batch')

    srv = RecommenderServer(model, host='127.0.0.1', port=0,
                            nbr_recommendations=n)
    port = srv.start()
    try:
        asked = users[rng.choice(n_users, n_requests, replace=False)]
        for u in asked:
            url = 'http://127.0.0.1:%d/recommend?user=%d&n=%d' % (port, u, n)
            with urllib.request.urlopen(url, timeout=120) as resp:
                body = json.loads(resp.read())
            row = int(np.searchsorted(users, u))
            got_ids = np.asarray(body['items'])
            got_sc = np.asarray(body['scores'])
            same = np.array_equal(got_ids, ids[row])
            # the server batches 256 users per device call: another
            # matmul shape may round the last bits differently, so
            # near-ties may swap places
            near = (set(got_ids) == set(ids[row])
                    and np.allclose(np.sort(got_sc), np.sort(sc[row]),
                                    rtol=1e-5, atol=1e-5))
            check(same or near, 'server /recommend for user %d differs '
                  'from recommend_batch: %s vs %s'
                  % (u, got_ids.tolist(), ids[row].tolist()))
    finally:
        srv.stop()
    log('server: %d /recommend answers on 127.0.0.1:%d equal '
        'recommend_batch' % (n_requests, port))
    log('phase recommend: ok')


# ------------------------------------------------------------ 5. wrmf
def phase_wrmf(seed, U_=U, I_=I, N_=N, epochs=4):
    import bench
    from mfrec_tpu.models.wrmf import WRMFRecommender
    t0 = time.perf_counter()
    tr_u, tr_i, te_u, te_i = bench.make_implicit_data(
        U_, I_, int(N_ * 2.3), seed=seed)
    model = WRMFRecommender(U_, I_, {
        'nbr_features': RANK, 'nbr_epochs': epochs, 'solver': 'cg',
        'cg_steps': 6, 'cg_warm_steps': 3, 'gram_dtype': 'bfloat16',
        'engine': 'als'})
    model.set_ratings(tr_u, tr_i, np.ones(tr_u.shape[0], np.float32))
    t1 = time.perf_counter()
    model.train()
    t2 = time.perf_counter()
    p5, p5_pop = bench._als_ranking_gate(
        np.asarray(model.P), np.asarray(model.Q), model.ratings, te_u, te_i,
        U_, I_, n=5)
    log('wrmf: nnz %d, data %.1f s, train %d epochs %.2f s (incl. '
        'compile), held-out P@5 %.4f vs popularity floor %.4f'
        % (model.ratings.nnz, t1 - t0, epochs, t2 - t1, p5, p5_pop))
    check(np.isfinite(np.asarray(model.P)).all(), 'non-finite WRMF factors')
    check(p5 > p5_pop, 'WRMF P@5 %.4f does not beat the popularity floor '
          '%.4f' % (p5, p5_pop))
    log('phase wrmf: ok')


# -------------------------------------------------------- --four-cards
def phase_four_cards(seed, rng, U_=U, I_=I, N_=N, als_shape=(8000, 2000,
                                                              400_000)):
    import jax
    import jax.numpy as jnp
    import bench
    from mfrec_tpu.ops import als as als_ops
    from mfrec_tpu.parallel.als_sharded import (make_sharded_als_epoch,
                                                padded_uniform)
    from mfrec_tpu.parallel.mesh import make_mesh
    from mfrec_tpu.data.movielens import ratings_from_arrays
    D = len(jax.devices())

    # (a) alternating_sharded (engine auto on >1 device) vs alternating
    users, items, vals, floor = make_ratings(seed, U_, I_, N_)
    m_sh = make_model(users, items, vals, U_, I_, engine='auto')
    m_sh.train(handle_bias=True)
    m_1 = make_model(users, items, vals, U_, I_, engine='alternating')
    m_1.train(handle_bias=True)
    h_sh = [float(x) for x in m_sh.rmse_history]
    h_1 = [float(x) for x in m_1.rmse_history]
    log('train over %d cards (alternating_sharded): rmse %s; one card '
        '(alternating): rmse %s; bias floor %.4f'
        % (D, ' '.join('%.4f' % h for h in h_sh),
           ' '.join('%.4f' % h for h in h_1), floor))
    # the sharded engine visits the ratings in another order (per-shard
    # batches, W=256 windows): equal quality, not equal bits
    check(all(np.isfinite(h_sh)) and h_sh[-1] < floor,
          'sharded training did not beat the bias floor')
    check(abs(h_sh[-1] - h_1[-1]) < 0.05, 'sharded vs single final RMSE '
          '%.4f vs %.4f (tol 0.05)' % (h_sh[-1], h_1[-1]))

    # (b) sharded top-N vs single-card, both in full float32 products
    # (identical ids test the sharding, not TF32 near-tie rounding)
    q_users = np.sort(rng.choice(U_, 1024, replace=False))
    with jax.default_matmul_precision('highest'):
        i_sh, s_sh = m_1.recommend_batch(q_users, 10, sharded=True)
        i_1, s_1 = m_1.recommend_batch(q_users, 10, sharded=False)
    check(np.array_equal(np.asarray(i_sh), np.asarray(i_1)),
          'sharded top-N ids differ from single-card')
    log('top-N: sharded over %d cards == single card for %d users (max '
        'score diff %.3e)' % (D, len(q_users), float(np.abs(
            np.asarray(s_sh) - np.asarray(s_1)).max())))

    # (c) sharded ALS epoch vs the single-card exact epoch
    Ua, Ia, Na = als_shape
    tr_u, tr_i, _, _ = bench.make_implicit_data(Ua, Ia, Na, seed=seed)
    r = ratings_from_arrays(tr_u, tr_i, np.ones(tr_u.shape[0], np.float32),
                            Ua, Ia)
    k = RANK
    u_idx, u_val, u_mask = padded_uniform(r, 'user', D)
    i_idx, i_val, i_mask = padded_uniform(r, 'item', D)
    P0 = np.random.default_rng(seed).normal(0, 0.1, (Ua, k)).astype(
        np.float32)
    Q0 = np.random.default_rng(seed + 1).normal(0, 0.1, (Ia, k)).astype(
        np.float32)
    with jax.default_matmul_precision('highest'):
        epoch = make_sharded_als_epoch(make_mesh(D), c_pos=1.0, reg=0.015)
        Pa, Qa = epoch(
            jnp.asarray(np.pad(P0, ((0, u_idx.shape[0] - Ua), (0, 0)))),
            jnp.asarray(np.pad(Q0, ((0, i_idx.shape[0] - Ia), (0, 0)))),
            *(jnp.asarray(x) for x in (u_idx, u_val, u_mask,
                                       i_idx, i_val, i_mask)))
        P1, Q1 = als_ops.als_wrmf_train(
            jnp.asarray(P0), jnp.asarray(Q0), r.padded_rows(axis='user'),
            r.padded_rows(axis='item'), nbr_epochs=1, c_pos=1.0, reg=0.015,
            solver='exact')
    dP = float(np.abs(np.asarray(Pa)[:Ua] - np.asarray(P1)).max())
    dQ = float(np.abs(np.asarray(Qa)[:Ia] - np.asarray(Q1)).max())
    scale = float(np.abs(np.asarray(P1)).max())
    log('ALS epoch: sharded vs single card max|dP| %.3e max|dQ| %.3e '
        '(|P| max %.3f; tol 1e-3 relative: f32 Cholesky of the same '
        'systems, Gram sums in another order)' % (dP, dQ, scale))
    check(max(dP, dQ) <= 1e-3 * max(scale, 1.0), 'sharded ALS differs')
    log('phase four-cards: ok')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the 4-GPU sharded path and its compares')
    args = ap.parse_args(argv)
    device = phase_device(4 if args.four_cards else 1)
    sys.path.insert(0, HERE)
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    log('compile cache: %s' % enable_compile_cache())
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            phase_four_cards(args.seed, rng)
        else:
            phase_half_pass(rng)
            model, _ = phase_train(args.seed)
            phase_recommend(model, rng)
            del model
            phase_wrmf(args.seed)
    except SmokeFailure as e:
        print('chip_smoke FAILED: %s' % e, file=sys.stderr)
        return 1
    log('all phases ok in %.1f s' % (time.perf_counter() - t0))
    print(json.dumps({'ok': True, 'device': device}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
