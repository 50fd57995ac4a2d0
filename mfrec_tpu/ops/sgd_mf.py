'''
SGD matrix-factorization kernels.

Two tiers, replacing the nine serial Cython loops of the reference
(``mfrec/lib/gd_estimator.pyx:210-996``):

* **serial tier** (`serial_feature_epoch`, `update_cache`) — bit-faithful
  re-expression of the reference's Funk-style feature-by-feature sweep
  (cached partial dot product, trailing-value term, [min,max] clamping,
  pre-update gradient reads).  Order-dependent and sequential by
  construction; used as the exactness oracle and for small fold-in
  retrains.  Reference: ``gd_estimator.pyx:38-73`` (estimator),
  ``:489-582`` (fixed-bias loop), ``:691-779`` (no-bias loop),
  ``:401-483`` (learned-bias loop).

* **fused tier** (`make_fused_epoch`) — all features trained
  simultaneously with mini-batch SGD; each batch does two row gathers, a
  batched dot, and duplicate-accumulating scatter-adds.  Update order differs from the serial reference, so parity
  is defined as final-RMSE tolerance (documented deviation; see
  SURVEY.md §7 "hard parts").

All functions are pure: they take and return factor pytrees.
'''
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MFState(NamedTuple):
    '''Factor/bias pytree.  P: [U, k] user factors; Q: [I, k] item factors;
    bu/bi: learned or precomputed biases; mu: overall average; Y: [I, k]
    implicit-feedback item factors (SVD++ ``y``), may be zeros.'''
    P: jax.Array
    Q: jax.Array
    bu: jax.Array
    bi: jax.Array
    mu: jax.Array
    Y: jax.Array


def _memo_epoch_builder(fn, _maxsize=64):
    '''Memoize an epoch-builder on its (hashable) config args.

    Every builder arg is a static scalar/string baked into the returned
    jitted closure, so identical configs yield interchangeable epoch
    functions — but a FRESH closure per call defeats jax.jit's
    function-identity cache, and each recompile of a large epoch program
    costs seconds to minutes.  The model layer
    rebuilds its epoch on every ``train()`` call (sweeps, retrains,
    fold-in refreshes), so without this memo the public API pays a full
    recompile per call where the ops-level bench pays one per process.
    Unhashable args bypass the memo.
    '''
    cache = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        try:
            hash(key)
        except TypeError:
            return fn(*args, **kwargs)
        if key not in cache:
            if len(cache) >= _maxsize:
                cache.clear()
            cache[key] = fn(*args, **kwargs)
        return cache[key]

    wrapper.cache_clear = cache.clear
    return wrapper




def init_state(nbr_users, nbr_items, k, feature_init=0.1, mode='constant',
               seed=0, dtype=jnp.float32):
    '''`constant` = reference SGD init (``gradient_descent.py:523-525``);
    `normal` = reference KMF init (``mf.py:124-133``).'''
    if mode == 'constant':
        P = jnp.full((nbr_users, k), feature_init, dtype)
        Q = jnp.full((nbr_items, k), feature_init, dtype)
    else:
        ku, ki = jax.random.split(jax.random.PRNGKey(seed))
        P = (jax.random.normal(ku, (nbr_users, k)) * feature_init).astype(dtype)
        Q = (jax.random.normal(ki, (nbr_items, k)) * feature_init).astype(dtype)
    z = lambda n: jnp.zeros((n,), dtype)
    return MFState(P=P, Q=Q, bu=z(nbr_users), bi=z(nbr_items),
                   mu=jnp.zeros((), dtype), Y=jnp.zeros((nbr_items, k), dtype))


def clamp(x, lo=1.0, hi=5.0):
    '''Rating clamp.  The reference's ``clamping`` ignores its min/max
    arguments and hardcodes [1, 5] (``gd_estimator.pyx:26-35``, a latent
    defect); here the bounds are honored, with the same defaults.'''
    return jnp.clip(x, lo, hi)


# --------------------------------------------------------------------------
# Serial tier — exact reference semantics (oracle / small retrains)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('bias_mode', 'update_users',
                                             'update_items'))
def serial_feature_epoch(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K,
                         mu, bu, bi, lr_bu, lr_bi, K_bu, K_bi,
                         bias_mode='none', lo=1.0, hi=5.0,
                         update_users=True, update_items=True,
                         P=None, Q=None):
    '''One strictly-sequential epoch of single-feature Funk SGD.

    pf: [U] user feature-f column, qf: [I] item feature-f column.
    cache: [N] per-rating frozen prediction from features < f
    (``gd_estimator.pyx:535-538``).  Returns (pf, qf, bu, bi, rmse).

    bias_mode:
      'none'    -> baseline 1.0 (``estimator_loop_without_bias`` :691)
      'fixed'   -> baseline mu+bi+bu, cached (``estimator_loop_with_bias`` :489)
      'learned' -> full dot product each step + SGD on biases
                   (``estimator_loop_with_learned_bias`` :401); needs P, Q.
    update_users/update_items replicate the fold-in masks of
    ``estimator_loop_with_bias_dev`` (:664-667).

    K_bu/K_bi: user-/item-bias regularization.  The reference's public
    parameters promise this split (``regularization_users_bias``->K2,
    ``regularization_items_bias``->K3, gradient_descent.py:68-69) but its
    kernel takes one K_bias and the caller passes K2 for both
    (gd_estimator.pyx:410, gradient_descent.py:502) — a latent defect;
    the split is honored here.
    '''
    n = uidx.shape[0]
    trailing = (dim - f - 1) * f_init * f_init

    def body(s, carry):
        pf, qf, bu, bi, sse = carry
        u = uidx[s]
        i = iidx[s]
        if bias_mode == 'learned':
            # full_estimator (gd_estimator.pyx:118-148): full dot, no cache
            full = mu + bi[i] + bu[u] + P[u] @ Q[i] - P[u, f] * Q[i, f] \
                + pf[u] * qf[i]
            p = clamp(full, lo, hi)
        else:
            base = jnp.where(cache[s] > 0, cache[s],
                             1.0 if bias_mode == 'none'
                             else mu + bi[i] + bu[u])
            p = clamp(base + pf[u] * qf[i], lo, hi)
        p = clamp(p + trailing, lo, hi)
        err = r[s] - p
        sse = sse + err * err
        cf = pf[u]
        mf = qf[i]
        if bias_mode == 'learned':
            bu = bu.at[u].add(lr_bu * (err - K_bu * bu[u]))
            bi = bi.at[i].add(lr_bi * (err - K_bi * bi[i]))
        if update_items:
            qf = qf.at[i].add(lr * (err * cf - K * mf))
        if update_users:
            pf = pf.at[u].add(lr * (err * mf - K * cf))
        return pf, qf, bu, bi, sse

    pf, qf, bu, bi, sse = jax.lax.fori_loop(
        0, n, body, (pf, qf, bu, bi, jnp.zeros((), pf.dtype)))
    rmse = jnp.sqrt(sse / n)
    return pf, qf, bu, bi, rmse


@functools.partial(jax.jit, static_argnames=('bias_mode',))
def update_cache(pf, qf, cache, uidx, iidx, mu, bu, bi, bias_mode='none',
                 lo=1.0, hi=5.0):
    '''Freeze feature f into the per-rating cache after it converges
    (``gd_estimator.pyx:573-580``).  Order-independent, so vectorized.'''
    base = jnp.where(cache > 0, cache,
                     1.0 if bias_mode == 'none' else mu + bi[iidx] + bu[uidx])
    return clamp(base + pf[uidx] * qf[iidx], lo, hi)


# --------------------------------------------------------------------------
# Fused tier — mini-batch all-features epoch
# --------------------------------------------------------------------------

@_memo_epoch_builder
def make_fused_epoch(batch_size, lr, K, lr_bu=0.0, lr_bi=0.0, K_bu=0.0,
                     K_bi=0.0, bias_mode='fixed', clamp_pred=True, lo=1.0,
                     hi=5.0, implicit=False, donate=True):
    '''Build a jitted epoch function.

    The returned ``epoch_fn(state, ub, ib, rb, mb) -> (state, rmse)`` takes
    ratings pre-reshaped to [nb, B] (+ a validity mask for padding) and scans
    mini-batches: gather P/Q rows, predict, scatter-add the regularized
    gradient step.  Duplicate indices within a batch accumulate — i.e.
    synchronous mini-batch SGD, the conflict-free replacement for the
    reference's serial sweep (``gd_estimator.pyx:363-378``).

    With ``implicit=True`` the state's Y factors are used SVD++-style:
    prediction uses (p_u + |N(u)|^-1/2 * sum_{j in N(u)} y_j) . q_i, and the
    per-batch y updates are scattered over the users' padded rating lists
    (reference intent of ``estimator_loop_with_implicit_feedback``
    :785-898 — whose inner-loop index clobbering we deliberately do not
    replicate, see SURVEY.md §2.6).  Requires extra args (flists [U, L],
    fmask [U, L]): each user's padded rated-item list, gathered per batch
    on device.
    '''

    def make_batch_step(flists, fmask):
        def batch_step(state, batch):
            u, i, r, m = batch
            P, Q, bu, bi, mu, Y = state
            pu = P[u]
            qi = Q[i]
            if implicit:
                fl = flists[u]                     # [B, L]
                fm = fmask[u]
                ysum = (Y[fl] * fm[..., None]).sum(1)
                fnorm = jax.lax.rsqrt(jnp.maximum(fm.sum(1), 1.0))[:, None]
                pu_eff = pu + fnorm * ysum
            else:
                pu_eff = pu
            dot = (pu_eff * qi).sum(-1)
            if bias_mode == 'none':
                pred = 1.0 + dot
            else:
                pred = mu + bu[u] + bi[i] + dot
            if clamp_pred:
                pred = clamp(pred, lo, hi)
            err = (r - pred) * m
            sse = (err * err).sum()

            gP = err[:, None] * qi - K * pu * m[:, None]
            gQ = err[:, None] * pu_eff - K * qi * m[:, None]
            P = P.at[u].add(lr * gP)
            Q = Q.at[i].add(lr * gQ)
            if bias_mode == 'learned':
                bu = bu.at[u].add(lr_bu * (err - K_bu * bu[u] * m))
                bi = bi.at[i].add(lr_bi * (err - K_bi * bi[i] * m))
            if implicit:
                gy = (err[:, None] * fnorm * qi)[:, None, :] * fm[..., None] \
                    - K * Y[fl] * fm[..., None]
                Y = Y.at[fl].add(lr * gy)
            return MFState(P, Q, bu, bi, mu, Y), sse
        return batch_step

    def epoch_fn(state, ub, ib, rb, mb, flists=None, fmask=None):
        state, sses = jax.lax.scan(make_batch_step(flists, fmask), state,
                                   (ub, ib, rb, mb))
        n = jnp.maximum(mb.sum(), 1.0)
        return state, jnp.sqrt(sses.sum() / n)

    return jax.jit(epoch_fn, donate_argnums=(0,) if donate else ())


# --------------------------------------------------------------------------
# Vmapped hyperparameter sweep — train S models simultaneously
# --------------------------------------------------------------------------

@_memo_epoch_builder
def make_multi_reg_epoch(lr, bias_mode='fixed', clamp_pred=True, lo=1.0,
                         hi=5.0):
    '''Train S models with different regularization strengths in ONE
    device program: factors stacked on a leading sweep axis, the fused
    mini-batch epoch vmapped over (P, Q, K).  The batched answer to the
    reference's sequential re-train sweeps (metaparameters.py).

    epoch_fn(Ps [S,U,k], Qs [S,I,k], bu [U], bi [I], mu, Ks [S],
             ub, ib, rb, mb) -> (Ps, Qs, rmses [S])
    '''

    def one_model(P, Q, K, bu, bi, mu, ub, ib, rb, mb):
        def batch_step(carry, batch):
            P, Q, sse = carry
            u, i, r, m = batch
            pu = P[u]
            qi = Q[i]
            dot = (pu * qi).sum(-1)
            pred = (1.0 + dot) if bias_mode == 'none' \
                else (mu + bu[u] + bi[i] + dot)
            if clamp_pred:
                pred = clamp(pred, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            P = P.at[u].add(lr * (err[:, None] * qi - K * pu * m[:, None]))
            Q = Q.at[i].add(lr * (err[:, None] * pu - K * qi * m[:, None]))
            return (P, Q, sse), None

        (P, Q, sse), _ = jax.lax.scan(batch_step, (P, Q, 0.0),
                                      (ub, ib, rb, mb))
        n = jnp.maximum(mb.sum(), 1.0)
        return P, Q, jnp.sqrt(sse / n)

    vm = jax.vmap(one_model,
                  in_axes=(0, 0, 0, None, None, None, None, None, None,
                           None))

    def epoch_fn(Ps, Qs, Ks, bu, bi, mu, ub, ib, rb, mb):
        return vm(Ps, Qs, Ks, bu, bi, mu, ub, ib, rb, mb)

    return jax.jit(epoch_fn)


# --------------------------------------------------------------------------
# Funk-fused tier — feature-by-feature schedule at mini-batch speed
# --------------------------------------------------------------------------

@_memo_epoch_builder
def make_funk_fused_feature_epoch(lr, K, bias_mode='none', lo=1.0, hi=5.0,
                                  donate=False):
    '''One mini-batch epoch of *single-feature* Funk training.

    Keeps the reference schedule's semantics at vectorized speed: cached
    partial predictions from converged features, the trailing-value term,
    clamping, per-feature convergence — but processes ratings in
    mini-batches with scatter-add updates instead of a serial sweep (the
    scalable middle ground between the exact serial tier and the
    all-features tiers).

    epoch_fn(pf [U,1], qf [I,1], base, trailing, ub, ib, rb, mb, cb)
      -> (pf, qf, rmse)
    where cb [nb, B] is the per-rating cache (stream-aligned) and base is
    the scalar baseline used when the cache is empty
    (1.0 / mu — per gd_estimator.pyx:60-63; for 'fixed' pass the
    per-rating baseline inside cb up front).
    '''

    def epoch_fn(pf, qf, trailing, ub, ib, rb, mb, cb):
        def batch_step(carry, batch):
            pf, qf, sse = carry
            u, i, r, m, c = batch
            pu = pf[u, 0]
            qi = qf[i, 0]
            pred = clamp(c + pu * qi, lo, hi)
            pred = clamp(pred + trailing, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            pf = pf.at[u, 0].add(lr * (err * qi - K * pu * m))
            qf = qf.at[i, 0].add(lr * (err * pu - K * qi * m))
            return (pf, qf, sse), None

        (pf, qf, sse), _ = jax.lax.scan(batch_step, (pf, qf, 0.0),
                                        (ub, ib, rb, mb, cb))
        n = jnp.maximum(mb.sum(), 1.0)
        return pf, qf, jnp.sqrt(sse / n)

    return jax.jit(epoch_fn, donate_argnums=(0, 1) if donate else ())


@_memo_epoch_builder
def make_funk_fused_learned_epoch(lr, lr_bu, lr_bi, K, K_bu, K_bi,
                                  lo=1.0, hi=5.0, donate=False):
    '''Mini-batch epoch of single-feature Funk training with LEARNED
    biases (the funk_fused analogue of ``estimator_loop_with_learned_bias``
    gd_estimator.pyx:401-483, which predicts with the FULL dot product
    each step).  The off-feature dot contribution is constant within a
    feature's epochs, so it rides a stream-aligned cache ``off`` [nb, B]:

        pred = clamp(mu + bu + bi + off + pf*qf + trailing)

    epoch_fn(pf [U,1], qf [I,1], bu [U], bi [I], mu, trailing,
             ub, ib, rb, mb, off) -> (pf, qf, bu, bi, rmse)
    '''

    def epoch_fn(pf, qf, bu, bi, mu, trailing, ub, ib, rb, mb, off):
        def batch_step(carry, batch):
            pf, qf, bu, bi, sse = carry
            u, i, r, m, o = batch
            pu = pf[u, 0]
            qi = qf[i, 0]
            pred = clamp(mu + bu[u] + bi[i] + o + pu * qi, lo, hi)
            pred = clamp(pred + trailing, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            bu = bu.at[u].add(lr_bu * (err - K_bu * bu[u] * m))
            bi = bi.at[i].add(lr_bi * (err - K_bi * bi[i] * m))
            pf = pf.at[u, 0].add(lr * (err * qi - K * pu * m))
            qf = qf.at[i, 0].add(lr * (err * pu - K * qi * m))
            return (pf, qf, bu, bi, sse), None

        (pf, qf, bu, bi, sse), _ = jax.lax.scan(
            batch_step, (pf, qf, bu, bi, 0.0), (ub, ib, rb, mb, off))
        n = jnp.maximum(mb.sum(), 1.0)
        return pf, qf, bu, bi, jnp.sqrt(sse / n)

    return jax.jit(epoch_fn, donate_argnums=(0, 1, 2, 3) if donate else ())


@jax.jit
def funk_fused_update_cache(pf, qf, ub, ib, cb, lo=1.0, hi=5.0):
    '''Freeze a converged feature into the stream-aligned cache
    (vectorized analogue of gd_estimator.pyx:573-580; cb already holds
    the baseline-or-previous-features value).'''
    return clamp(cb + pf[ub, 0] * qf[ib, 0], lo, hi)


# --------------------------------------------------------------------------
# Sorted-window tier — scatter-free alternating SGD (the flagship path)
# --------------------------------------------------------------------------

def sorted_pass_layout(uidx, iidx, vals, batch_size, axis='user',
                       max_window=512):
    '''Host-side layout for one alternating half-epoch.

    Sorts the rating stream by `axis` key so every batch touches a
    *contiguous window* of factor rows; scatter-add then becomes per-row
    window work (``sorted_half_pass``) — no scatter op at
    all.  Batches are packed greedily: a batch closes when it reaches
    ``batch_size`` ratings OR its key span reaches ``max_window`` (keeps
    the one-hot width bounded on long-tail key distributions).

    Returns (ub, ib, rb, mb, kl, lo, W): batch tensors [nb, B], per-batch
    local key ids kl, window starts lo, and the static window size W.
    '''
    key = uidx if axis == 'user' else iidx
    # native O(N) counting sort: np.argsort(stable) costs ~120 s on the
    # 100M-row Netflix stream vs seconds here
    from mfrec_tpu import native
    order = native.counting_sort(np.ascontiguousarray(key, np.int32),
                                 int(key.max()) + 1 if key.size else 1)
    u, i, v = uidx[order], iidx[order], vals[order]
    k_sorted = key[order]
    n = u.shape[0]
    W = int(max_window)

    bounds = []
    start = 0
    while start < n:
        end = min(start + batch_size, n)
        limit = int(np.searchsorted(k_sorted, k_sorted[start] + W,
                                    side='left'))
        end = min(end, max(limit, start + 1))
        bounds.append((start, end))
        start = end
    nb = len(bounds)

    ub = np.zeros((nb, batch_size), np.int32)
    ib = np.zeros((nb, batch_size), np.int32)
    rb = np.zeros((nb, batch_size), np.float32)
    mb = np.zeros((nb, batch_size), np.float32)
    lo = np.zeros((nb,), np.int32)
    for b, (s, e) in enumerate(bounds):
        m = e - s
        # valid slots first, each key's run contiguous and ascending: the
        # half-pass kernel relies on this order (``run_offsets``)
        ub[b, :m] = u[s:e]
        ib[b, :m] = i[s:e]
        rb[b, :m] = v[s:e]
        mb[b, :m] = 1.0
        # pad index slots with the batch's first key (valid window rows)
        ub[b, m:] = u[s]
        ib[b, m:] = i[s]
        lo[b] = k_sorted[s]
    keyb = ub if axis == 'user' else ib
    kl = (keyb - lo[:, None]).astype(np.int32)
    return ub, ib, rb, mb, kl, lo, W


def augment_factors(P, Q, bu, bi):
    '''Pack biases into the factor matrices as extra columns, so bias
    terms ride the row gathers instead of costing separate scalar
    gathers:

        Paug = [P | bu | 1],  Qaug = [Q | 1 | bi]
        dot(Paug_u, Qaug_i) = P_u . Q_i + bu_u + bi_i
    '''
    xp = jnp if isinstance(P, jax.Array) else np
    onesP = xp.ones((P.shape[0], 1), P.dtype)
    onesQ = xp.ones((Q.shape[0], 1), Q.dtype)
    Paug = xp.concatenate([P, bu[:, None], onesP], axis=1)
    Qaug = xp.concatenate([Q, onesQ, bi[:, None]], axis=1)
    return Paug, Qaug


def split_factors(Paug, Qaug):
    '''Inverse of ``augment_factors``: returns (P, Q, bu, bi).'''
    k = Paug.shape[1] - 2
    return Paug[:, :k], Qaug[:, :k], Paug[:, k], Qaug[:, k + 1]


def half_pass_kernel_default():
    '''The one place that picks the sorted-window half-pass
    implementation: the Pallas kernel (``ops.pallas_half_pass``, Triton
    route) on a GPU, the XLA sweeps (``window_half_pass_xla``) anywhere
    else.  The kernel runs in interpret mode only when a caller passes
    ``interpret=True`` explicitly (tests).'''
    return jax.default_backend() == 'gpu'


def col_vectors(kdim, upd_is_user, lr, reg, lr_bias=0.0, reg_bias=0.0,
                learned=False, freeze_factors=False):
    '''Per-column learning rates and regularization for augmented rows
    (``augment_factors``): user rows ``[P | bu | 1]``, item rows
    ``[Q | 1 | bi]``.  The constant column never moves; the own bias
    column trains only when ``learned`` (it keeps ``reg_bias`` either
    way — with a zero rate it is inert); ``freeze_factors`` pins the
    factor columns (the FN tier's derived user profiles).'''
    lrv = np.full(kdim + 2, lr, np.float32)
    regv = np.full(kdim + 2, reg, np.float32)
    own_bias_col = kdim if upd_is_user else kdim + 1
    const_col = kdim + 1 if upd_is_user else kdim
    lrv[own_bias_col] = lr_bias if learned else 0.0
    lrv[const_col] = 0.0
    regv[own_bias_col] = reg_bias
    regv[const_col] = 0.0
    if freeze_factors:
        lrv[:kdim] = 0.0
    return jnp.asarray(lrv), jnp.asarray(regv)


def window_half_pass_xla(win, ff, r, m, kl, lrv, regv, mu, *, W, chunk,
                         inner_steps=1, link='identity', clamp_pred=True,
                         lo_r=1.0, hi_r=5.0, row_mean=True,
                         bias_none=False):
    '''XLA sweeps of one sorted-window batch: ``inner_steps`` gradient
    iterations of the W window rows ``win`` against the pre-gathered
    fixed rows ``ff`` [B, k].  Per-row gradients are aggregated with a
    chunked one-hot bf16 matmul (f32 accumulation) into the window — no
    scatter op.  Returns (window, SSE of the sweep-0 residual).'''
    c = min(chunk, kl.shape[0])
    pad = -kl.shape[0] % c
    if pad:
        # mask-0 slots contribute nothing to the aggregation
        kl, m, r = (jnp.pad(a, (0, pad)) for a in (kl, m, r))
        ff = jnp.pad(ff, ((0, pad), (0, 0)))
    B = kl.shape[0]
    kc = kl.reshape(B // c, c)
    # the one-hot tile and per-row counts are invariant across the inner
    # iterations — build once
    onehot = (kc[:, :, None] ==
              jnp.arange(W)[None, None, :]).astype(jnp.bfloat16)
    if row_mean:
        mc = m.reshape(B // c, c).astype(jnp.bfloat16)
        cnt = jnp.einsum('nc,ncw->w', mc, onehot,
                         preferred_element_type=jnp.float32)
        cnt = jnp.maximum(cnt, 1.0)[:, None]

    # fori_loop, not a python range: at the shipped T=128 an unrolled
    # loop makes the traced graph (and compile time) explode
    def sweep(t, carry):
        win, sse = carry
        fu = win[kl]                  # [B, k] gather from the window
        dot = (fu * ff).sum(-1)
        if link == 'logistic':
            # kernel MF: s = dot (+biases via aug cols); pred =
            # lo + sigmoid(s)*range; grad factor sigmoid'(s)*range
            # (kmf_train.pyx:158-165)
            rng_w = hi_r - lo_r
            sig = jax.nn.sigmoid(dot)
            err = (r - (lo_r + sig * rng_w)) * m
            eff = err * sig * (1.0 - sig) * rng_w
        else:
            pred = (1.0 + dot) if bias_none else (mu + dot)
            if clamp_pred:
                pred = clamp(pred, lo_r, hi_r)
            err = (r - pred) * m
            eff = err
        # epoch RMSE = the pre-update residual (t == 0 only)
        sse = jnp.where(t == 0, sse + (err * err).sum(), sse)
        g = eff[:, None] * ff - regv[None, :] * fu * m[:, None]
        gc = g.reshape(B // c, c, -1).astype(jnp.bfloat16)
        gsum = jnp.einsum('nck,ncw->wk', gc, onehot,
                          preferred_element_type=jnp.float32)
        if row_mean:
            gsum = gsum / cnt
        return win + lrv[None, :] * gsum, sse

    return jax.lax.fori_loop(0, inner_steps, sweep,
                             (win, jnp.zeros((), jnp.float32)))


def sorted_half_pass(F_upd, F_fix, fix, r, m, kl, lo, lrv, regv, mu, *,
                     W, chunk=4096, inner_steps=1, link='identity',
                     clamp_pred=True, lo_r=1.0, hi_r=5.0, row_mean=True,
                     bias_none=False, kernel=None, interpret=False):
    '''One sorted-window half-pass: batch by batch (fix/r/m/kl [nb, B],
    window starts lo [nb]), the W-row window of ``F_upd`` at ``lo`` takes
    ``inner_steps`` sweeps against the fixed rows ``F_fix[fix]``.  Runs
    the Pallas kernel (one program per factor row, the whole half-pass in
    one launch) when ``kernel`` (default: ``half_pass_kernel_default()``),
    else a scan of XLA window sweeps.  The kernel needs the sorted-window
    layout (valid slots first, grouped by ``kl`` ascending); the XLA
    sweeps take any slot order.  Returns (F_upd, SSE of the sweep-0
    residuals).'''
    if kernel is None:
        kernel = half_pass_kernel_default()
    kw = dict(inner_steps=inner_steps, link=link, clamp_pred=clamp_pred,
              lo_r=lo_r, hi_r=hi_r, row_mean=row_mean, bias_none=bias_none)
    if kernel:
        from mfrec_tpu.ops import pallas_half_pass
        return pallas_half_pass.half_pass(F_upd, F_fix, fix, r, m, kl, lo,
                                          lrv, regv, mu, W=W,
                                          interpret=interpret, **kw)

    def step(carry, batch):
        F_upd, sse = carry
        fix_b, r_b, m_b, kl_b, lo_b = batch
        win = jax.lax.dynamic_slice_in_dim(F_upd, lo_b, W, 0)
        win, sse_b = window_half_pass_xla(
            win, F_fix[fix_b].astype(jnp.float32), r_b, m_b, kl_b, lrv,
            regv, mu, W=W, chunk=chunk, **kw)
        F_upd = jax.lax.dynamic_update_slice_in_dim(F_upd, win, lo_b, 0)
        return (F_upd, sse + sse_b), None

    (F_upd, sse), _ = jax.lax.scan(
        step, (F_upd, jnp.zeros((), jnp.float32)), (fix, r, m, kl, lo))
    return F_upd, sse


@_memo_epoch_builder
def make_alternating_epoch(W_user, W_item, lr, K, lr_bu=0.0, lr_bi=0.0,
                           K_bu=0.0, K_bi=0.0, bias_mode='fixed',
                           clamp_pred=True, lo_r=1.0, hi_r=5.0, chunk=4096,
                           donate=True, row_mean=True, inner_steps=1,
                           ff_dtype=None, link='identity', K_u=None,
                           K_i=None, freeze_user_factors=False):
    '''Build a jitted scatter-free epoch over *augmented* factors: a P
    half-pass over the user-sorted stream (Q fixed), then a Q half-pass
    over the item-sorted stream (P fixed) — blockwise-alternating SGD.

    Each batch touches a contiguous W-row window of the updated side
    (``sorted_pass_layout``); ``sorted_half_pass`` trains the windows
    (the Pallas kernel on a GPU, XLA window sweeps with one dynamic-slice
    update per batch elsewhere) — no scatter op anywhere.  With ``row_mean`` each row
    receives its *mean* gradient over the batch (sorted batches
    concentrate rows, so summed steps would explode); use a
    correspondingly larger learning rate than per-sample SGD.

    Update order differs from the serial reference, so parity is
    final-RMSE tolerance like the fused tier.

    ``inner_steps``: gradient iterations per batch.  Sorted batches give
    each factor row only ~1 averaged step per epoch (a user's ratings are
    contiguous), so convergence per epoch is slow; T inner iterations
    reuse the already-gathered fixed side and recompute only
    prediction/gradient against the updated window — ~T-fold faster
    convergence per epoch for well under T-fold epoch cost.

    ``ff_dtype='bfloat16'`` casts the fixed side once per half-pass for
    the kernel's gathers (an accepted mixed-precision deviation: the
    kernel upcasts to f32 before the arithmetic); the XLA sweeps always
    read it in f32.

    epoch_fn(Paug, Qaug, mu, p_layout, q_layout) -> (Paug, Qaug, rmse).
    Paug must have >= nbr_users + W_user rows (Qaug likewise);
    layouts are the device-resident tensors of ``sorted_pass_layout``
    minus W.  Build/unpack Paug/Qaug with ``augment_factors`` /
    ``split_factors``.

    ``link``: prediction link function — 'identity' (explicit MF) or
    'logistic' (kernel MF, Rendle: pred = lo + sigmoid(s)*(hi-lo) with
    s = dot + biases; the gradient picks up sigmoid'(s)*(hi-lo)) —
    the sorted-window re-expression of ``kmf_train.pyx:103-193``.
    ``K_u``/``K_i``: per-side factor regularization overrides (KMF's
    regularization_users/items split); default both = K.
    '''
    learned = bias_mode == 'learned'
    K_u = K if K_u is None else K_u
    K_i = K if K_i is None else K_i
    kernel = half_pass_kernel_default()

    def half_pass(F_upd, F_fix, mu, batches, W, upd_is_user,
                  lr_scale=1.0):
        if kernel and ff_dtype == 'bfloat16':
            # cast the fixed side ONCE per half-pass so the kernel's row
            # gathers move half the bytes
            F_fix = F_fix.astype(jnp.bfloat16)
        lrv, regv = col_vectors(
            F_upd.shape[1] - 2, upd_is_user, lr, K_u if upd_is_user else K_i,
            lr_bu if upd_is_user else lr_bi, K_bu if upd_is_user else K_bi,
            learned, freeze_user_factors and upd_is_user)
        lrv = lrv * lr_scale
        u, i, r, m, kl, lo = batches
        return sorted_half_pass(
            F_upd, F_fix, i if upd_is_user else u, r, m, kl, lo, lrv, regv,
            mu, W=W, chunk=chunk, inner_steps=inner_steps, link=link,
            clamp_pred=clamp_pred, lo_r=lo_r, hi_r=hi_r, row_mean=row_mean,
            bias_none=(bias_mode == 'none'), kernel=kernel)

    def epoch_fn(Paug, Qaug, mu, p_layout, q_layout, lr_scale=1.0):
        # epoch RMSE pools BOTH half-passes so the convergence rule sees
        # a statistic no staler than half an epoch.
        # ``lr_scale`` is a TRACED scalar multiplying every learning
        # rate (factor + bias columns): per-epoch decay schedules run
        # against ONE compiled program instead of one rebuild per rate.
        s = jnp.asarray(lr_scale, jnp.float32)
        Paug, sse_p = half_pass(Paug, Qaug, mu, p_layout, W_user, True, s)
        Qaug, sse_q = half_pass(Qaug, Paug, mu, q_layout, W_item, False, s)
        n = jnp.maximum(p_layout[3].sum() + q_layout[3].sum(), 1.0)
        return Paug, Qaug, jnp.sqrt((sse_p + sse_q) / n)

    return jax.jit(epoch_fn, donate_argnums=(0, 1) if donate else ())


def _agg_window(g, kl, m, W, chunk, row_mean):
    '''One-hot matmul aggregation of per-sample rows g [B, k] into the
    batch's W-row window by window-local ids kl (masked rows contribute
    nothing).  Returns [W, k] sums (or per-row means).'''
    c = min(chunk, g.shape[0])
    pad = -g.shape[0] % c
    if pad:
        g = jnp.pad(g, ((0, pad), (0, 0)))
        kl = jnp.pad(kl, (0, pad))
        m = jnp.pad(m, (0, pad))
    B = g.shape[0]
    gc = (g * m[:, None]).reshape(B // c, c, -1).astype(jnp.bfloat16)
    kc = kl.reshape(B // c, c)
    onehot = (kc[:, :, None] ==
              jnp.arange(W)[None, None, :]).astype(jnp.bfloat16)
    gsum = jnp.einsum('nck,ncw->wk', gc, onehot,
                      preferred_element_type=jnp.float32)
    if row_mean:
        mc = m.reshape(B // c, c).astype(jnp.bfloat16)
        cnt = jnp.einsum('nc,ncw->w', mc, onehot,
                         preferred_element_type=jnp.float32)
        gsum = gsum / jnp.maximum(cnt, 1.0)[:, None]
    return gsum


def _scan_window_agg(target, layout, source_fn, W, chunk, mean):
    '''Accumulate ``source_fn(u, i, r, m)`` rows into ``target`` windows
    over a sorted-pass layout — the scatter-free profile-aggregation
    phase shared by the implicit (SVD++) and FN alternating tiers.'''
    def step(tgt, batch):
        u, i, r, m, kl, lo = batch
        vals = source_fn(u, i, r, m)
        gsum = _agg_window(vals, kl, m, W, chunk, mean)
        win = jax.lax.dynamic_slice_in_dim(tgt, lo, W, 0)
        tgt = jax.lax.dynamic_update_slice_in_dim(tgt, win + gsum, lo, 0)
        return tgt, None
    tgt, _ = jax.lax.scan(step, target, layout)
    return tgt


@_memo_epoch_builder
def make_alternating_implicit_epoch(W_user, W_item, lr, lr_y, K, K_y,
                                    clamp_pred=True, lo_r=1.0, hi_r=5.0,
                                    chunk=4096, row_mean=True,
                                    donate=True, inner_steps=1):
    '''SVD++ (implicit feedback) at sorted-window speed — every phase is
    scatter-free window work:

        r_hat = mu + b_u + b_i + q_i . (p_u + |N(u)|^-1/2 sum_j y_j)

    Per epoch (the mini-batch re-expression of
    ``estimator_loop_with_implicit_feedback``, gd_estimator.pyx:785-898,
    whose serial loop is defective — SURVEY §2.6):

      1. A[u] = nrm_u * sum_{j in R(u)} y_j — aggregate Y rows into user
         windows over the user-sorted stream (one-hot matmul agg).
      2. P half-pass on the EFFECTIVE factors Peff = Paug + A.  The
         error-gradient part is linear, so subtracting A afterwards
         recovers p_u's error updates exactly; the L2 decay, however,
         applies to Peff — this tier regularizes the effective user
         vector ||p_u + A_u||^2 rather than Koren's ||p_u||^2 alone
         (DELIBERATE deviation: predictions depend only on p_u + A_u,
         so p_u alone is not identifiable and shrinking the composite
         is the better-posed penalty; A_u keeps its own shrinkage
         through the K_y decay on Y in step 5.  Validated empirically —
         the benchmarked RMSE 0.310 and the T-ladder quality gates all
         train this objective).
      3. Q half-pass against the updated Peff.
      4. G[u] = nrm_u * sum_{i in R(u)} err_ui q_i — error-weighted item
         factors aggregated into user windows.
      5. y_j += lr_y * (mean_{u: j in N(u)} G[u] - K_y y_j) — G rows
         aggregated into ITEM windows over the item-sorted stream.

    epoch_fn(Paug, Qaug, Ypad, mu, p_layout, q_layout, nrm_rows)
      -> (Paug, Qaug, Ypad, rmse)
    Ypad: [nbr_items + W_item, k] implicit factors (padded like Qaug);
    nrm_rows: [nbr_users + W_user] per-user |N(u)|^-1/2 (0 for empty).
    N(u) = R(u), as in the reference.  Fixed-bias mode (biases in the
    augmented columns); epoch RMSE pools both half-passes.
    '''
    base = make_alternating_epoch(W_user, W_item, lr, K,
                                  bias_mode='fixed', clamp_pred=clamp_pred,
                                  lo_r=lo_r, hi_r=hi_r, chunk=chunk,
                                  donate=False, row_mean=row_mean,
                                  inner_steps=inner_steps)

    def scan_agg(target, layout, source_fn, W, mean):
        return _scan_window_agg(target, layout, source_fn, W, chunk, mean)

    def epoch_fn(Paug, Qaug, Ypad, mu, p_layout, q_layout, nrm_rows,
                 lr_scale=1.0):
        # traced schedule scale, like the explicit tier: scales the P/Q
        # half-pass rates (through base's lr_scale) AND the Y step
        s = jnp.asarray(lr_scale, jnp.float32)
        k = Ypad.shape[1]
        # 1) user aggregates of Y (sum over rated items, then * nrm)
        A = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        A = scan_agg(A, p_layout,
                     lambda u, i, r, m: Ypad[i], W_user, mean=False)
        A = A * nrm_rows[:, None]
        Apad = jnp.pad(A, ((0, 0), (0, 2)))        # zero bias/const cols
        # 2+3) standard alternating epoch on the effective factors
        Peff = Paug + Apad
        Peff, Qaug, rmse = base(Peff, Qaug, mu, p_layout, q_layout, s)
        Paug = Peff - Apad
        # 4) error-weighted item-factor sums into user windows
        def err_q(u, i, r, m):
            fu = Peff[u]
            ff = Qaug[i]
            pred = mu + (fu * ff).sum(-1)
            if clamp_pred:
                pred = clamp(pred, lo_r, hi_r)
            err = (r - pred) * m
            return err[:, None] * ff[:, :k]
        G = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        G = scan_agg(G, p_layout, err_q, W_user, mean=False)
        G = G * nrm_rows[:, None]
        # 5) aggregate G into item windows, step Y (reg rides per-sample
        # like the main tier, so untouched rows get no decay)
        def y_step(Y, batch):
            u, i, r, m, kl, lo = batch
            win = jax.lax.dynamic_slice_in_dim(Y, lo, W_item, 0)
            vals = G[u] - K_y * win[kl]
            gsum = _agg_window(vals, kl, m, W_item, chunk, row_mean)
            win = win + (lr_y * s) * gsum
            return jax.lax.dynamic_update_slice_in_dim(Y, win, lo, 0), None
        Ypad2, _ = jax.lax.scan(y_step, Ypad, q_layout)
        return Paug, Qaug, Ypad2, rmse

    return jax.jit(epoch_fn, donate_argnums=(0, 1, 2) if donate else ())


def batch_ratings(uidx, iidx, r, batch_size, seed=None):
    '''Host-side: pad and reshape COO ratings to [nb, B] scan layout.
    Returns (ub, ib, rb, mask).'''
    n = uidx.shape[0]
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(n)
        uidx, iidx, r = uidx[perm], iidx[perm], r[perm]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    mask = np.ones(n, np.float32)
    uidx = np.pad(uidx, (0, pad)).reshape(nb, batch_size)
    iidx = np.pad(iidx, (0, pad)).reshape(nb, batch_size)
    r = np.pad(r, (0, pad)).reshape(nb, batch_size).astype(np.float32)
    mask = np.pad(mask, (0, pad)).reshape(nb, batch_size)
    return uidx, iidx, r, mask
