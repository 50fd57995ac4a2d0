'''
Factorized-neighborhood SGD kernels (Koren KDD'08, "Factorization Meets
the Neighborhood", the factored item-item model of §4).

Model: every item carries three factor vectors — q_i (target), x_j
(explicit-neighborhood weights factor) and y_j (implicit offsets) — and
the prediction for (u, i) is

    r_hat = mu + b_u + b_i + q_i . a_u
    a_u   = |R(u)|^-1/2 * sum_{j in R(u)} [ (r_uj - b_uj) x_j + y_j ]
    b_uj  = mu + b_u + b_j          (baseline at aggregation time)

i.e. the item-item weights w_ij / c_ij of the full neighborhood model are
factorized as q_i.x_j / q_i.y_j, which turns the O(I^2) weight matrix
into three [I, k] factors and makes training/serving pure matmul work.

This is the model the reference *declares* and never delivers
(``mfrec/recommendation/fn.py:19-96``: ``train`` eval-dispatches to
never-imported kernels, ``predict`` is ``pass``).

Design: one jitted scan over rating mini-batches; per batch the user's
padded rated list [B, L] is gathered, the aggregate a_u computed with
batched einsums, and q/x/y/biases updated with
duplicate-accumulating scatter-adds — the same conflict-free mini-batch
semantics as the fused MF tier (ops/sgd_mf.py).  Parity with the
strictly-sequential oracle (reference_numpy.fn_train_oracle) is defined
as final-RMSE tolerance, like every order-changing tier.
'''
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mfrec_tpu.ops.sgd_mf import _memo_epoch_builder


class FNState(NamedTuple):
    '''Q: [I, k] target item factors; X: [I, k] explicit-weight factors;
    Y: [I, k] implicit factors; bu/bi: learned biases; mu: overall avg.'''
    Q: jax.Array
    X: jax.Array
    Y: jax.Array
    bu: jax.Array
    bi: jax.Array
    mu: jax.Array


def init_fn_state(nbr_users, nbr_items, k, feature_init=0.1, seed=0,
                  mu=0.0, dtype=jnp.float32):
    kq, kx, ky = jax.random.split(jax.random.PRNGKey(seed), 3)
    f = feature_init
    return FNState(
        Q=(jax.random.normal(kq, (nbr_items, k)) * f).astype(dtype),
        X=(jax.random.normal(kx, (nbr_items, k)) * f).astype(dtype),
        Y=(jax.random.normal(ky, (nbr_items, k)) * f).astype(dtype),
        bu=jnp.zeros((nbr_users,), dtype),
        bi=jnp.zeros((nbr_items,), dtype),
        mu=jnp.asarray(mu, dtype))


def user_aggregates(state, fl, fv, fm):
    '''a_u for every user in one shot: [U, k].

    fl/fv/fm: [U, L] padded per-user rated item ids / values / mask.
    Used to materialize serving profiles (P := A makes every MF top-N /
    similarity kernel work unchanged on an FN model).'''
    Q, X, Y, bu, bi, mu = state
    base = mu + bu[:, None] + bi[fl]
    resid = (fv - base) * fm
    nrm = jax.lax.rsqrt(jnp.maximum(fm.sum(1), 1.0))[:, None]
    agg = jnp.einsum('ul,ulk->uk', resid, X[fl],
                     preferred_element_type=jnp.float32)
    agg = agg + jnp.einsum('ul,ulk->uk', fm, Y[fl],
                           preferred_element_type=jnp.float32)
    return nrm * agg


def make_fn_epoch(lr, lr_bu, lr_bi, K, K_bu, K_bi, K_y=None, lo=1.0,
                  hi=5.0, clamp_pred=True, donate=True):
    '''Build the jitted epoch:

        epoch_fn(state, ub, ib, rb, mb, fl, fv, fm) -> (state, rmse)

    ub/ib/rb/mb: [nb, B] batched rating stream (sgd_mf.batch_ratings);
    fl/fv/fm: [U, L] padded per-user rated lists (ids, values, mask).
    K regularizes q and x; K_y (default K) the implicit y factors.
    '''
    K_y = K if K_y is None else K_y

    def make_batch_step(fl, fv, fm):
        def batch_step(state, batch):
            u, i, r, m = batch
            Q, X, Y, bu, bi, mu = state
            flu = fl[u]                                  # [B, L]
            fvu = fv[u]
            fmu = fm[u]
            base = mu + bu[u][:, None] + bi[flu]
            resid = (fvu - base) * fmu                   # [B, L]
            nrm = jax.lax.rsqrt(jnp.maximum(fmu.sum(1), 1.0))  # [B]
            Xg = X[flu]                                  # [B, L, k]
            Yg = Y[flu]
            agg = nrm[:, None] * (
                jnp.einsum('bl,blk->bk', resid, Xg,
                           preferred_element_type=jnp.float32)
                + jnp.einsum('bl,blk->bk', fmu, Yg,
                             preferred_element_type=jnp.float32))
            qi = Q[i]
            pred = mu + bu[u] + bi[i] + (qi * agg).sum(-1)
            if clamp_pred:
                pred = jnp.clip(pred, lo, hi)
            err = (r - pred) * m
            sse = (err * err).sum()

            bu = bu.at[u].add(lr_bu * (err - K_bu * bu[u] * m))
            bi = bi.at[i].add(lr_bi * (err - K_bi * bi[i] * m))
            Q = Q.at[i].add(lr * (err[:, None] * agg - K * qi * m[:, None]))
            # neighborhood factors: every j in R(u) steps scaled by
            # err * |R(u)|^-1/2 (x_j additionally by the residual)
            en = (err * nrm)[:, None]                    # [B, 1]
            mask3 = (fmu * m[:, None])[..., None]        # [B, L, 1]
            gX = (en * resid)[..., None] * qi[:, None, :] - K * Xg
            gY = en[..., None] * qi[:, None, :] - K_y * Yg
            X = X.at[flu].add(lr * gX * mask3)
            Y = Y.at[flu].add(lr * gY * mask3)
            return FNState(Q, X, Y, bu, bi, mu), sse
        return batch_step

    def epoch_fn(state, ub, ib, rb, mb, fl, fv, fm):
        state, sses = jax.lax.scan(make_batch_step(fl, fv, fm), state,
                                   (ub, ib, rb, mb))
        n = jnp.maximum(mb.sum(), 1.0)
        return state, jnp.sqrt(sses.sum() / n)

    return jax.jit(epoch_fn, donate_argnums=(0,) if donate else ())


@_memo_epoch_builder
def make_fn_alternating_epoch(W_user, W_item, lr, lr_bu, lr_bi, lr_xy,
                              K, K_bu, K_bi, K_x=None, K_y=None,
                              clamp_pred=True, lo=1.0, hi=5.0, chunk=4096,
                              row_mean=True, donate=True, inner_steps=1):
    '''FN (Koren KDD'08 §4) at sorted-window speed — the fast tier for
    the model the reference only declares (``fn.py:19-96``); every phase
    is scatter-free window work.

    The FN prediction is mu + b_u + b_i + q_i . a_u with the DERIVED
    per-user profile a_u = |R(u)|^-1/2 sum_{j in R(u)} [resid_uj x_j +
    y_j].  The sorted-window re-expression mirrors the implicit (SVD++)
    tier (``sgd_mf.make_alternating_implicit_epoch``), swapping its
    free p_u for the rebuilt profile:

      1. A[u] — aggregate resid_uj*x_j + y_j into user windows over the
         user-sorted stream (one-hot matmul agg), scale by nrm_u, and
         INSTALL into the user factor columns (they are not free
         parameters).
      2. user half-pass with frozen factor columns
         (``freeze_user_factors``): trains b_u only, T sweeps.
      3. item half-pass: trains q_i and b_i against the installed
         profiles — the shared sorted-window half-pass (Pallas kernel
         on a GPU) applies unchanged.
      4. G[u] = nrm_u * sum_{i in R(u)} err_ui q_i into user windows.
      5. x_j += lr_xy*(mean_u resid_uj G[u] - K_x x_j) and
         y_j += lr_xy*(mean_u G[u] - K_y y_j), both aggregated into
         ITEM windows over the item-sorted stream.

    Like the implicit tier, X/Y step once per epoch from the
    whole-epoch G (update-order deviation from the per-batch fused
    tier; parity is final-RMSE tolerance).

    epoch_fn(Paug, Qaug, Xpad, Ypad, mu, p_layout, q_layout, nrm_rows,
             lr_scale=1.0) -> (Paug, Qaug, Xpad, Ypad, rmse)
    Paug: [U + W_user, k+2] augmented user rows — factor columns hold
    the installed a_u, column k the learned b_u.  Xpad/Ypad:
    [I + W_item, k] neighborhood factors (padded like Qaug);
    nrm_rows: [U + W_user] per-user |R(u)|^-1/2 (0 for empty).
    '''
    from mfrec_tpu.ops import sgd_mf
    K_x = K if K_x is None else K_x
    K_y = K if K_y is None else K_y
    base = sgd_mf.make_alternating_epoch(
        W_user, W_item, lr, K, lr_bu=lr_bu, lr_bi=lr_bi,
        K_bu=K_bu, K_bi=K_bi, bias_mode='learned',
        clamp_pred=clamp_pred, lo_r=lo, hi_r=hi, chunk=chunk,
        donate=False, row_mean=row_mean, inner_steps=inner_steps,
        freeze_user_factors=True)

    def epoch_fn(Paug, Qaug, Xpad, Ypad, mu, p_layout, q_layout,
                 nrm_rows, lr_scale=1.0):
        s = jnp.asarray(lr_scale, jnp.float32)
        k = Xpad.shape[1]
        bu = Paug[:, k]
        bi = Qaug[:, k + 1]

        # 1) profiles: A[u] = nrm_u * sum_j [resid_uj x_j + y_j]
        def xy_src(u, i, r, m):
            resid = r - (mu + bu[u] + bi[i])
            return resid[:, None] * Xpad[i] + Ypad[i]
        A = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        A = sgd_mf._scan_window_agg(A, p_layout, xy_src, W_user, chunk,
                                    mean=False)
        A = A * nrm_rows[:, None]
        Paug = Paug.at[:, :k].set(A)

        # 2+3) half-passes (user side factor-frozen: b_u only)
        Paug, Qaug, rmse = base(Paug, Qaug, mu, p_layout, q_layout, s)

        # 4) error-weighted item-factor sums into user windows
        def err_q(u, i, r, m):
            fu = Paug[u]
            ff = Qaug[i]
            pred = mu + (fu * ff).sum(-1)
            if clamp_pred:
                pred = sgd_mf.clamp(pred, lo, hi)
            err = (r - pred) * m
            return err[:, None] * ff[:, :k]
        G = jnp.zeros((Paug.shape[0], k), Paug.dtype)
        G = sgd_mf._scan_window_agg(G, p_layout, err_q, W_user, chunk,
                                    mean=False)
        G = G * nrm_rows[:, None]

        # 5) step X and Y over item windows (post-half-pass biases feed
        # the residual weights; reg rides per-sample like the main tier
        # so untouched rows get no decay)
        bu2 = Paug[:, k]
        bi2 = Qaug[:, k + 1]

        def xy_step(carry, batch):
            X, Y = carry
            u, i, r, m, kl, lo_ = batch
            winX = jax.lax.dynamic_slice_in_dim(X, lo_, W_item, 0)
            winY = jax.lax.dynamic_slice_in_dim(Y, lo_, W_item, 0)
            resid = r - (mu + bu2[u] + bi2[i])
            Gu = G[u]
            gX = resid[:, None] * Gu - K_x * winX[kl]
            gY = Gu - K_y * winY[kl]
            aggX = sgd_mf._agg_window(gX, kl, m, W_item, chunk, row_mean)
            aggY = sgd_mf._agg_window(gY, kl, m, W_item, chunk, row_mean)
            X = jax.lax.dynamic_update_slice_in_dim(
                X, winX + (lr_xy * s) * aggX, lo_, 0)
            Y = jax.lax.dynamic_update_slice_in_dim(
                Y, winY + (lr_xy * s) * aggY, lo_, 0)
            return (X, Y), None

        (Xpad, Ypad), _ = jax.lax.scan(xy_step, (Xpad, Ypad), q_layout)
        return Paug, Qaug, Xpad, Ypad, rmse

    return jax.jit(epoch_fn, donate_argnums=(0, 1, 2, 3) if donate else ())


def padded_user_lists(ratings, cap=None):
    '''Host-side [U, L] padded (ids, values, mask) per-user rated lists —
    vectorized grid fill.'''
    from mfrec_tpu.data.ratings import padded_segment_gather
    ptr, items, vals = ratings.csr()
    counts = np.diff(ptr)
    # L policy: batch-max rated count, optionally capped
    L = max(int(counts.max()) if counts.size else 1, 1)
    if cap is not None:
        L = min(L, int(cap))
    rows = np.arange(ptr.shape[0] - 1, dtype=np.int64)
    fl, fv, mask = padded_segment_gather(ptr, rows, L, items, vals)
    return fl, fv, mask
