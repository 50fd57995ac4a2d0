'''
Weighted-Regularized implicit ALS (WRMF) — batched normal equations.

Replaces ``mfrec/lib/als_implicit.pyx:211-352`` (per-row Gram assembly via a
serial CSR walk, with ``np.linalg.inv`` called once *per user/item row*)
with a batched formulation: per half-sweep, one Gram matmul
``HH = F^T F``, then — per nnz-bucket of padded neighbor lists — batched
rank-L corrections ``A^T A`` (an einsum that maps to batched matrix
products) and a batched Cholesky solve.

Model (Hu/Koren/Volinsky ICDM'08, as the reference implements it):
confidence c_ui = 1 + c_pos for observed pairs and 1 otherwise, preference
p_ui = 1(observed).  Per user u:
    M_u = HH + sum_{i in N(u)} c_pos q_i q_i^T + reg*I
    b_u = sum_{i in N(u)} (1 + c_pos) q_i
    p_u = M_u^{-1} b_u
(reference: ``als_implicit.pyx:257-302``; the general rating-scaled
confidence c_ui = 1 + alpha*r_ui is also supported via ``alpha``).
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=('gram_dtype',))
def _bucket_solve(F, out, HH, rows, nbr_idx, nbr_val, mask, c_pos, alpha,
                  reg, gram_dtype=None):
    '''Solve the normal equations for one nnz-bucket of rows.

    F: [n_other, k] fixed-side factors; out: [n_this, k] factors being
    updated; rows: [R] row ids in this bucket; nbr_idx/nbr_val/mask: [R, L]
    padded neighbor lists.  ``gram_dtype='bfloat16'`` computes the rank-L
    Gram corrections with bf16 inputs and f32 accumulation (the k x k
    solve stays f32).  Returns ``out`` with the bucket rows replaced.
    '''
    k = F.shape[1]
    A = F[nbr_idx] * mask[..., None]                  # [R, L, k]
    # c_ui - 1 for observed entries (zero where padded)
    cm1 = jnp.where(alpha > 0, alpha * nbr_val, c_pos) * mask   # [R, L]
    Ag = A if gram_dtype is None else A.astype(gram_dtype)
    Aw = (A * cm1[..., None]) if gram_dtype is None \
        else (A * cm1[..., None]).astype(gram_dtype)
    M = HH[None] + jnp.einsum('rlk,rlm->rkm', Aw, Ag,
                              preferred_element_type=jnp.float32)
    M = M + reg * jnp.eye(k, dtype=jnp.float32)[None]
    b = ((1.0 + cm1)[..., None] * A).sum(1)           # [R, k]
    L = jnp.linalg.cholesky(M)
    sol = jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
    return out.at[rows].set(sol.astype(out.dtype))


def pcg_solve(M, b, x0, steps):
    '''Warm-started Jacobi-preconditioned CG on batched materialized
    systems: M [R, k, k], b [R, k], x0 [R, k] -> x [R, k].  The mat-vec
    is one batched [k,k]@[k,1] matmul, and the warm start keeps the step
    count small (shared by the single-device bucket sweeps and the
    sharded ALS epoch).  A float32 mat-vec may run in TF32 on GPUs with
    tensor cores (XLA's default matmul precision).'''
    def Mv(v):
        return jnp.matmul(M, v[..., None],
                          preferred_element_type=jnp.float32)[..., 0]

    D = jnp.maximum(jnp.diagonal(M, axis1=1, axis2=2), 1e-12)   # Jacobi
    eps = 1e-20
    x = x0
    r = b - Mv(x)
    z = r / D
    p = z
    rz = (r * z).sum(-1)
    for _ in range(steps):
        Mp = Mv(p)
        denom = (p * Mp).sum(-1)
        a = jnp.where(denom > eps, rz / jnp.maximum(denom, eps), 0.0)
        x = x + a[:, None] * p
        r = r - a[:, None] * Mp
        z = r / D
        rz_new = (r * z).sum(-1)
        beta = jnp.where(rz > eps, rz_new / jnp.maximum(rz, eps), 0.0)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def _bucket_cg_body(F, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos,
                    alpha, reg, steps):
    '''Traceable body of ``_bucket_cg`` (shared with the fused one-jit
    epoch, ``make_cg_epoch``).

    ``F`` may be pre-cast to bfloat16 by the caller (one cast per
    half-sweep): the [R, L, k] neighbor gather — the dominant HBM
    traffic of the Gram assembly — then moves half the bytes and never
    materializes in f32.  The Gram contraction weights carry mask*cm1,
    so the unmasked bf16 gather is correct for M; the rhs b applies
    (1+cm1)*mask as a batched mat-vec with f32 accumulation.'''
    A = F[nbr_idx]                                    # [R, L, k] (bf16 ok)
    cm1 = jnp.where(alpha > 0, alpha * nbr_val, c_pos) * mask   # [R, L]
    Ab = A.astype(jnp.bfloat16)
    Awb = Ab * cm1[..., None].astype(jnp.bfloat16)
    M = HHreg[None] + jnp.einsum('rlk,rlm->rkm', Awb, Ab,
                                 preferred_element_type=jnp.float32)
    b = jnp.einsum('rl,rlk->rk', (1.0 + cm1) * mask, Ab,
                   preferred_element_type=jnp.float32)
    x = pcg_solve(M, b, out[rows], steps)
    return out.at[rows].set(x.astype(out.dtype))


@functools.partial(jax.jit, static_argnames=('steps',))
def _bucket_cg(F, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos, alpha,
               reg, steps=6):
    '''Gram assembly + Jacobi-preconditioned CG for one nnz-bucket,
    warm-started from the rows' current values (Takács & Pilászy's ALS-CG
    idea).

    The [R, k, k] normal matrices ARE materialized (one bf16 Gram einsum)
    but the batch-sequential Cholesky is replaced by `steps` CG
    iterations whose mat-vec is one batched [k,k]@[k,1] matmul.'''
    return _bucket_cg_body(F, out, HHreg, rows, nbr_idx, nbr_val, mask,
                           c_pos, alpha, reg, steps)


@functools.lru_cache(maxsize=64)
def make_cg_epoch(n_user_buckets, n_item_buckets, c_pos, alpha, reg,
                  steps):
    '''One-jit CG epoch: both half-sweeps over every nnz-bucket compiled
    into a single device program.  The unfused path pays one dispatch
    PER BUCKET per half-sweep (~20 calls/epoch); this folds them into
    one call.  Buckets are passed flattened (4 arrays each, users
    then items) so they are jit ARGUMENTS, not baked-in constants.
    Memoized: repeated ``als_wrmf_train`` calls with the same config
    reuse the same jitted function (and its compile cache) instead of
    retracing a fresh closure per call.'''

    def epoch(P, Q, u_alive, i_alive, *flat):
        k = P.shape[1]
        eye = reg * jnp.eye(k, dtype=jnp.float32)
        ub = [tuple(flat[4 * j:4 * j + 4])
              for j in range(n_user_buckets)]
        off = 4 * n_user_buckets
        ib = [tuple(flat[off + 4 * j:off + 4 * j + 4])
              for j in range(n_item_buckets)]
        HHreg = (Q.T @ Q + eye).astype(jnp.float32)
        Qb = Q.astype(jnp.bfloat16)        # one cast per half-sweep:
        for rows, nidx, nval, mask in ub:  # gathers move half the bytes
            P = _bucket_cg_body(Qb, P, HHreg, rows, nidx, nval, mask,
                                c_pos, alpha, reg, steps)
        P = P * u_alive
        HHreg = (P.T @ P + eye).astype(jnp.float32)
        Pb = P.astype(jnp.bfloat16)
        for rows, nidx, nval, mask in ib:
            Q = _bucket_cg_body(Pb, Q, HHreg, rows, nidx, nval, mask,
                                c_pos, alpha, reg, steps)
        Q = Q * i_alive
        return P, Q

    # no donation: callers (tests, warm restarts) reuse their P0/Q0 across
    # runs, and the factor copies are trivial next to the Gram work
    return jax.jit(epoch)


def device_buckets(buckets):
    '''Move a ``padded_rows`` bucket list to the device ONCE.  The sweep
    functions accept either host or device buckets, but re-uploading the
    O(nnz) padded tensors every epoch costs more than the solves —
    convert up front for multi-epoch training.'''
    return [tuple(jnp.asarray(x) for x in b) for b in buckets]


def als_half_sweep_cg(F_fixed, F_update, buckets, c_pos=1.0, alpha=0.0,
                      reg=0.015, cg_steps=6):
    '''One half-sweep via warm-started preconditioned CG (see _bucket_cg).
    Same buckets contract as ``als_half_sweep``.'''
    k = F_fixed.shape[1]
    HHreg = (F_fixed.T @ F_fixed
             + reg * jnp.eye(k, dtype=jnp.float32)).astype(jnp.float32)
    Fb = F_fixed.astype(jnp.bfloat16)
    for rows, nbr_idx, nbr_val, mask in buckets:
        F_update = _bucket_cg(
            Fb, F_update, HHreg,
            jnp.asarray(rows), jnp.asarray(nbr_idx), jnp.asarray(nbr_val),
            jnp.asarray(mask), jnp.float32(c_pos), jnp.float32(alpha),
            jnp.float32(reg), steps=int(cg_steps))
    return F_update


def als_half_sweep(F_fixed, F_update, buckets, c_pos=1.0, alpha=0.0,
                   reg=0.015, gram_dtype=None):
    '''One half-sweep (all users, or all items).

    buckets: output of ``Ratings.padded_rows`` — list of
    (rows, nbr_idx, nbr_val, mask) with per-bucket static shapes.
    '''
    HH = (F_fixed.T @ F_fixed).astype(jnp.float32)
    for rows, nbr_idx, nbr_val, mask in buckets:
        F_update = _bucket_solve(
            F_fixed, F_update, HH,
            jnp.asarray(rows), jnp.asarray(nbr_idx), jnp.asarray(nbr_val),
            jnp.asarray(mask), jnp.float32(c_pos), jnp.float32(alpha),
            jnp.float32(reg), gram_dtype=gram_dtype)
    return F_update


def _alive_mask(buckets, nrows):
    alive = np.zeros((nrows, 1), np.float32)
    for rows, _, _, _ in buckets:
        alive[np.asarray(rows)] = 1.0
    return alive


def als_wrmf_train(P, Q, user_buckets, item_buckets, nbr_epochs=20,
                   c_pos=1.0, alpha=0.0, reg=0.015, callback=None,
                   gram_dtype=None, solver='exact', cg_steps=6,
                   cg_warm_steps=None, cg_warmup_epochs=2):
    '''Full WRMF training: alternate user and item half-sweeps
    (reference main loop ``als_implicit.pyx:250-352``).

    P: [U, k] user factors, Q: [I, k] item factors (both updated).
    user_buckets index into Q (each user's rated items); item_buckets index
    into P.  Returns (P, Q).

    Zero-rating rows are zeroed after each half-sweep: the reference
    solves M^-1 @ 0 = 0 for them DURING the pass (als_implicit.pyx:
    296-302), so they must not contribute their init values to the next
    Gram HH — leaving them stale diverges from the reference from the
    second half-sweep on (caught by the class-level parity test).

    ``solver='cg'`` runs warm-started matrix-free CG half-sweeps
    (``als_half_sweep_cg``) instead of the exact batched Cholesky —
    much faster per epoch at the same fixed point; 'exact' is
    the oracle-parity mode.

    ``cg_warm_steps`` (default None = same as ``cg_steps``): CG
    iterations per half-sweep AFTER the first ``cg_warmup_epochs``
    epochs.  Once the alternating iteration is near its fixed point the
    warm-started residual is small, so later epochs need fewer CG steps
    for the same trajectory at unchanged final objective (see
    tests/test_als.py warm-schedule parity).
    '''
    u_alive = jnp.asarray(_alive_mask(user_buckets, P.shape[0]))
    i_alive = jnp.asarray(_alive_mask(item_buckets, Q.shape[0]))
    user_buckets = device_buckets(user_buckets)
    item_buckets = device_buckets(item_buckets)
    if cg_warm_steps is None:
        cg_warm_steps = cg_steps
    if solver == 'cg':
        # one-jit epochs: a single device dispatch per epoch instead of
        # one per bucket per half-sweep (see make_cg_epoch)
        flat = [x for b in user_buckets for x in b] \
            + [x for b in item_buckets for x in b]
        epoch_fns = {}
        for steps in {cg_steps, cg_warm_steps}:
            epoch_fns[steps] = make_cg_epoch(
                len(user_buckets), len(item_buckets),
                float(c_pos), float(alpha), float(reg), int(steps))
    for epoch in range(nbr_epochs):
        if solver == 'cg':
            steps = cg_steps if epoch < cg_warmup_epochs else cg_warm_steps
            P, Q = epoch_fns[steps](P, Q, u_alive, i_alive, *flat)
        else:
            P = als_half_sweep(Q, P, user_buckets, c_pos, alpha, reg,
                               gram_dtype) * u_alive
            Q = als_half_sweep(P, Q, item_buckets, c_pos, alpha, reg,
                               gram_dtype) * i_alive
        if callback is not None:
            callback(epoch, P, Q)
    return P, Q


# --------------------------------------------------------------------------
# Slow oracle (numpy, mirrors the Cython reference exactly)
# --------------------------------------------------------------------------

def als_wrmf_oracle(nbr_epochs, dim, u, v, users_row, users_col, items_row,
                    items_col, nbr_users, nbr_items, c_pos=1, k=0.015):
    '''Direct numpy re-expression of ``als_implicit.pyx:211-352`` (same
    inputs: (row-count-with-leading-0, col-index) arrays, u=[dim, items],
    v=[dim, users]).  Kept as the slow-oracle twin for tests — the
    reference's own pattern (``als_wrmf_dense``, ``als_implicit.pyx:71``).'''
    for _ in range(nbr_epochs):
        HH = u @ u.T
        start = 0
        for j in range(users_row.shape[0] - 1):
            start += users_row[j]
            span = users_row[j + 1]
            cols = users_col[start:start + span]
            sub = u[:, cols]
            M = HH + c_pos * (sub @ sub.T) + k * np.eye(dim)
            rhs = (1 + c_pos) * sub.sum(1)
            v[:, j] = np.linalg.inv(M) @ rhs
        HH = v @ v.T
        start = 0
        for j in range(items_row.shape[0] - 1):
            start += items_row[j]
            span = items_row[j + 1]
            cols = items_col[start:start + span]
            sub = v[:, cols]
            M = HH + c_pos * (sub @ sub.T) + k * np.eye(dim)
            rhs = (1 + c_pos) * sub.sum(1)
            u[:, j] = np.linalg.inv(M) @ rhs
    return u, v
