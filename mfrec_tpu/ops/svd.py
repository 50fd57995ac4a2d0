'''
Truncated SVD of the sparse ratings matrix — randomized subspace iteration.

Replaces the reference's third-party ``sparsesvd`` call
(``base.py:1181-1189``, ``simplesvd.py:75-82``) with a batched
randomized SVD (Halko/Martinsson/Tropp 2011): the sparse matrix is used as
an *implicit operator* via COO segment-sums, so every dense product is a
matmul and the full matrix is never densified.
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def coo_matmul(rows, cols, vals, X, n_rows):
    '''(A @ X) for COO A [n_rows, n_cols] and dense X [n_cols, p].'''
    return jax.ops.segment_sum(vals[:, None] * X[cols], rows,
                               num_segments=n_rows)


def coo_rmatmul(rows, cols, vals, X, n_cols):
    '''(A.T @ X) for COO A and dense X [n_rows, p].'''
    return jax.ops.segment_sum(vals[:, None] * X[rows], cols,
                               num_segments=n_cols)


@functools.partial(jax.jit, static_argnames=('n_rows', 'n_cols', 'k',
                                             'oversample', 'n_iter'))
def randomized_svd(rows, cols, vals, n_rows, n_cols, k, oversample=10,
                   n_iter=6, seed=0):
    '''Top-k SVD of the sparse matrix A given in COO form.

    Returns (U [n_rows, k], s [k], Vt [k, n_cols]) with descending singular
    values.  ``n_iter`` power iterations with QR re-orthonormalization give
    accuracy comparable to Lanczos for the well-separated spectra of
    ratings matrices.
    '''
    p = min(k + oversample, min(n_rows, n_cols))
    G = jax.random.normal(jax.random.PRNGKey(seed), (n_cols, p),
                          dtype=vals.dtype)
    Y = coo_matmul(rows, cols, vals, G, n_rows)
    Qm, _ = jnp.linalg.qr(Y)
    for _ in range(n_iter):
        Z = coo_rmatmul(rows, cols, vals, Qm, n_cols)
        Z, _ = jnp.linalg.qr(Z)
        Y = coo_matmul(rows, cols, vals, Z, n_rows)
        Qm, _ = jnp.linalg.qr(Y)
    B = coo_rmatmul(rows, cols, vals, Qm, n_cols).T        # [p, n_cols]
    Ub, s, Vt = jnp.linalg.svd(B, full_matrices=False)
    U = Qm @ Ub
    return U[:, :k], s[:k], Vt[:k]
