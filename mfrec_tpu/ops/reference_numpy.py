'''
Pure-numpy slow-oracle twins of the reference Cython kernels.

The reference keeps pure-python twins of each optimized loop as dev tools
(``feature_training_prototype`` gradient_descent.py:214-257,
``als_wrmf_dense`` als_implicit.pyx:71); we follow the same strategy: these
functions re-express the Cython semantics line-for-line in numpy (float64,
strictly sequential) and are used by the test suite to validate both the
order-faithful serial JAX kernels (near bit-parity) and the fused
device kernels (final-RMSE parity).

Layout note: these oracles use the *reference* layout u=[dim, items],
v=[dim, users] (base.py:144-146).
'''
from __future__ import annotations

import numpy as np


def clamping(value, lo=1.0, hi=5.0):
    '''gd_estimator.pyx:26-35 (bounds honored; reference hardcodes 1..5).'''
    return min(max(value, lo), hi)


def estimator(f, u, v, dim, f_init, cache=0.0, trailing=0, overall_avg=1.0,
              item_bias=0.0, user_bias=0.0, lo=1.0, hi=5.0):
    '''gd_estimator.pyx:38-73.'''
    s = cache if cache > 0 else overall_avg + item_bias + user_bias
    s += u * v
    s = clamping(s, lo, hi)
    if trailing == 1:
        s += (dim - f - 1) * f_init * f_init
        s = clamping(s, lo, hi)
    return s


def funk_train_oracle(min_epochs, max_epochs, min_improvement, dim, f_init,
                      lr, K, u, v, ratings_index, ratings, bias_mode='none',
                      overall_avg=0.0, items_bias=None, users_bias=None,
                      lr_users=0.0, lr_items=0.0, K_bias_users=0.0,
                      K_bias_items=0.0,
                      update_users=True, update_items=True,
                      lo=1.0, hi=5.0, cap_epochs=True):
    '''Feature-by-feature Funk SGD, mirroring
    ``estimator_loop_without_bias`` (gd_estimator.pyx:691-779, bias_mode
    'none'), ``estimator_loop_with_bias`` (:489-582, 'fixed') and
    ``estimator_loop_with_learned_bias`` (:401-483, 'learned'), including
    the per-rating cache, the trailing-value term, the pre-update gradient
    reads and the epoch rule.  Mutates u, v (and biases) in place; returns
    the per-epoch rmse history.'''
    n = ratings.shape[0]
    cache = np.zeros(n)
    hist = []
    for f in range(dim):
        # rmse_last reset per feature (same min_epochs=0 converge-only
        # semantics as ConvergenceDriver — it must neither NameError on
        # the first feature nor leak across features)
        rmse, rmse_last, epoch = 2.0, 2.0, 0
        while epoch < min_epochs or rmse <= rmse_last - min_improvement:
            if cap_epochs and epoch >= max_epochs:
                break
            rmse_last = rmse
            sse = 0.0
            for s in range(n):
                ui = ratings_index[s, 0]
                ii = ratings_index[s, 1]
                r = ratings[s]
                if bias_mode == 'learned':
                    full = overall_avg + items_bias[ii] + users_bias[ui] \
                        + float(u[:, ii] @ v[:, ui])
                    p = clamping(full, lo, hi)
                    p = clamping(p + (dim - f - 1) * f_init * f_init, lo, hi)
                elif bias_mode == 'fixed':
                    p = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                  cache[s], 1, overall_avg, items_bias[ii],
                                  users_bias[ui], lo, hi)
                else:
                    p = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                  cache[s], 1, 1.0, 0.0, 0.0, lo, hi)
                err = r - p
                sse += err * err
                cf = v[f, ui]
                mf = u[f, ii]
                if bias_mode == 'learned':
                    # K2/K3 split per the public parameter names
                    # (regularization_users_bias / _items_bias,
                    # gradient_descent.py:68-69); the reference kernel
                    # collapses both to K2 (gradient_descent.py:502) —
                    # a latent defect not replicated.
                    users_bias[ui] += lr_users * (
                        err - K_bias_users * users_bias[ui])
                    items_bias[ii] += lr_items * (
                        err - K_bias_items * items_bias[ii])
                if update_items:
                    u[f, ii] += lr * (err * cf - K * mf)
                if update_users:
                    v[f, ui] += lr * (err * mf - K * cf)
            rmse = np.sqrt(sse / n)
            hist.append(rmse)
            epoch += 1
        if bias_mode != 'learned':
            for s in range(n):
                ui = ratings_index[s, 0]
                ii = ratings_index[s, 1]
                if bias_mode == 'fixed':
                    cache[s] = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                         cache[s], 0, overall_avg,
                                         items_bias[ii], users_bias[ui],
                                         lo, hi)
                else:
                    cache[s] = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                         cache[s], 0, 1.0, 0.0, 0.0, lo, hi)
    return hist


def kmf_train_oracle(nbr_epochs, dim, lr, K_users, K_items, K_bias, u, v,
                     ratings_index, ratings, items_bias, users_bias,
                     kernel='logistic', update_users=True, update_items=True,
                     lo=1.0, hi=5.0):
    '''Kernel-MF SGD mirroring ``train_logistic_kernel``
    (kmf_train.pyx:103-189) and ``train_linear_kernel`` (:195-277).
    Mutates u, v, biases in place; returns final rmse.'''
    n = ratings.shape[0]
    rng = hi - lo
    rmse = 0.0
    for _ in range(nbr_epochs):
        sse = 0.0
        for s in range(n):
            ui = ratings_index[s, 0]
            ii = ratings_index[s, 1]
            r = ratings[s]
            dot = float(u[:, ii] @ v[:, ui]) + items_bias[ii] + users_bias[ui]
            if kernel == 'logistic':
                sig = 1.0 / (1.0 + np.exp(-dot))
                p = lo + sig * rng
                grad_scale = sig * (1.0 - sig) * rng
            else:
                p = dot
                grad_scale = 1.0
            err = r - p
            sse += err * err
            grad = err * grad_scale
            if update_users:
                users_bias[ui] += lr * (grad - K_bias * users_bias[ui])
            if update_items:
                items_bias[ii] += lr * (grad - K_bias * items_bias[ii])
            for f in range(dim):
                cf = v[f, ui]
                mf = u[f, ii]
                if update_items:
                    u[f, ii] += lr * (grad * cf - K_items * mf)
                if update_users:
                    v[f, ui] += lr * (grad * mf - K_users * cf)
        rmse = np.sqrt(sse / n)
    return rmse


def fn_train_oracle(nbr_epochs, lr, lr_bu, lr_bi, K, K_bu, K_bi, mu,
                    Q, X, Y, bu, bi, ratings_index, ratings, rated_ids,
                    rated_vals, K_y=None, lo=1.0, hi=5.0):
    '''Strictly-sequential factorized-neighborhood SGD (Koren KDD'08 §4,
    the factored item-item model) — the slow twin of ``ops.fn``'s fused
    mini-batch kernel.  Row-major layout (Q/X/Y: [items, k]); mutates
    Q, X, Y, bu, bi in place; returns the final epoch rmse.

    rated_ids/rated_vals: per-user python lists of (item ids, ratings).
    The reference's fn.py never implemented this model (train dispatches
    to never-imported kernels, predict is ``pass`` — fn.py:75-96), so
    there is no Cython loop to mirror; this oracle IS the spec.'''
    K_y = K if K_y is None else K_y
    n = ratings.shape[0]
    rmse = 0.0
    for _ in range(nbr_epochs):
        sse = 0.0
        for s in range(n):
            u = ratings_index[s, 0]
            i = ratings_index[s, 1]
            r = ratings[s]
            ids = rated_ids[u]
            vals = rated_vals[u]
            resid = vals - (mu + bu[u] + bi[ids])
            nrm = 1.0 / np.sqrt(max(len(ids), 1))
            a = nrm * (resid @ X[ids] + Y[ids].sum(0))
            pred = clamping(mu + bu[u] + bi[i] + float(Q[i] @ a), lo, hi)
            err = r - pred
            sse += err * err
            bu[u] += lr_bu * (err - K_bu * bu[u])
            bi[i] += lr_bi * (err - K_bi * bi[i])
            qi = Q[i].copy()
            Q[i] += lr * (err * a - K * qi)
            X[ids] += lr * ((err * nrm) * resid[:, None] * qi[None, :]
                            - K * X[ids])
            Y[ids] += lr * ((err * nrm) * qi[None, :] - K_y * Y[ids])
        rmse = np.sqrt(sse / n)
    return rmse


def window_half_pass(win, ff, r, m, kl, lrv, regv, mu, inner_steps=1,
                     link='identity', clamp_pred=True, lo_r=1.0, hi_r=5.0,
                     row_mean=True, bias_none=False):
    '''float64 twin of one sorted-window batch of the alternating
    engine (``sgd_mf.window_half_pass_xla``): T = ``inner_steps`` gradient
    sweeps of the W window rows against the batch's pre-gathered fixed
    rows ``ff`` [B, k].  Per sweep every slot predicts from its row's
    current value (``1 + dot`` with ``bias_none``, else ``mu + dot``,
    clamped to [lo_r, hi_r] when ``clamp_pred``; the logistic link
    ``lo_r + sigmoid(dot) * (hi_r - lo_r)`` instead), and each row takes
    one step of ``lrv * g`` where g sums ``eff * ff - regv * row`` over
    its slots (the mean over them with ``row_mean``).  Bias modes are
    column patterns of ``lrv``/``regv`` over the augmented
    ``[factors | bias | 1]`` rows.  Returns (window [W, k], SSE of the
    sweep-0 residual).'''
    win = np.array(win, np.float64)
    ff = np.asarray(ff, np.float64)
    r = np.asarray(r, np.float64)
    m = np.asarray(m, np.float64)
    kl = np.asarray(kl, np.int64)
    lrv = np.asarray(lrv, np.float64)
    regv = np.asarray(regv, np.float64)
    W = win.shape[0]
    cnt = np.bincount(kl, weights=m, minlength=W)[:W]
    sse0 = 0.0
    for t in range(int(inner_steps)):
        fu = win[kl]
        dot = (fu * ff).sum(1)
        if link == 'logistic':
            sig = 1.0 / (1.0 + np.exp(-dot))
            err = (r - (lo_r + sig * (hi_r - lo_r))) * m
            eff = err * sig * (1.0 - sig) * (hi_r - lo_r)
        else:
            pred = (1.0 if bias_none else float(mu)) + dot
            if clamp_pred:
                pred = np.clip(pred, lo_r, hi_r)
            err = (r - pred) * m
            eff = err
        if t == 0:
            sse0 = float((err * err).sum())
        g = eff[:, None] * ff - regv[None, :] * fu * m[:, None]
        gsum = np.zeros_like(win)
        np.add.at(gsum, kl, g)
        if row_mean:
            gsum /= np.maximum(cnt, 1.0)[:, None]
        win = win + lrv[None, :] * gsum
    return win, sse0


def sorted_half_pass(F_upd, F_fix, fix, r, m, kl, lo, lrv, regv, mu, W,
                     **kw):
    '''float64 twin of a whole sorted-window half-pass
    (``sgd_mf.sorted_half_pass``): ``window_half_pass`` on each batch's
    W-row window of ``F_upd`` in batch order, written back in place.
    Returns (F_upd, summed sweep-0 SSE).'''
    F = np.array(F_upd, np.float64)
    F_fix = np.asarray(F_fix, np.float64)
    sse = 0.0
    for b in range(np.shape(r)[0]):
        s = int(lo[b])
        win, sse_b = window_half_pass(F[s:s + W], F_fix[np.asarray(fix[b])],
                                      r[b], m[b], kl[b], lrv, regv, mu,
                                      **kw)
        F[s:s + W] = win
        sse += sse_b
    return F, sse
