'''
Similarity engine: one matmul instead of O(n^2) python loops.

Replaces the per-row scans of the reference (``base.py:1294-1466``,
``gradient_descent.py:688-766``, ``knn_users.py:72-136``): factors are
normalized once, similarities to a query batch are a single matmul,
and all-pairs caches are built blocked with fused top-k.

Methods (matching the reference's dispatch tables):
  'cosine'        a.b / (|a||b|)                       (base.py:1247)
  'cosine_log'    log1p(cosine)                        (base.py:1258)
  'pearson'       cosine of row-mean-centered vectors  (base.py:1269)
  'norm_cosine'   log1p(cosine of component-mean-centered vectors)
                                                       (gradient_descent.py:814)
  'euclidean'     negative euclidean distance (the reference sorts raw
                  distances descending, i.e. returns the *farthest* rows —
                  a latent defect we do not replicate; see SURVEY.md §2.6)
  'cosine_binary' |A∩B| / sqrt(|A||B|) on rated-sets   (knn_users.py:72)
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -3.0e38


def _prep(F, method, eps=1e-12):
    if method == 'pearson':
        F = F - F.mean(axis=1, keepdims=True)
        method = 'cosine'
    if method == 'norm_cosine':
        # component-mean centering (reference gradient_descent.py:
        # 814-824): the per-component mean of the passed matrix IS the
        # model's components_mean restricted to these columns, so the
        # centering lives here and direct ops callers get the
        # documented semantics (GDRecommender.similar_items pre-centers
        # with the same quantity and rewrites to 'cosine_log')
        F = F - F.mean(axis=0, keepdims=True)
    if method in ('cosine', 'cosine_log', 'norm_cosine'):
        norms = jnp.sqrt((F * F).sum(1))
        Fn = F / jnp.maximum(norms, eps)[:, None]
        return Fn, method
    return F, method


@functools.partial(jax.jit, static_argnames=('method',))
def similarity_to_queries(F, query_rows, method='cosine'):
    '''Similarities of every row of F [n, k] to each query row [B, k].
    Returns [B, n].'''
    if method == 'euclidean':
        d2 = ((query_rows[:, None, :] - F[None, :, :]) ** 2).sum(-1)
        return -jnp.sqrt(jnp.maximum(d2, 0.0))
    if method == 'pearson':
        F = F - F.mean(axis=1, keepdims=True)
        query_rows = query_rows - query_rows.mean(axis=1, keepdims=True)
        method = 'cosine'
    if method == 'norm_cosine':
        # queries center by F's component mean (the reference centers
        # both sides with the SAME components_mean), not their own
        mu = F.mean(axis=0, keepdims=True)
        F = F - mu
        query_rows = query_rows - mu
    Fn, _ = _prep(F, 'cosine')
    Qn, _ = _prep(query_rows, 'cosine')
    s = Qn @ Fn.T
    if method in ('cosine_log', 'norm_cosine'):
        s = jnp.log1p(jnp.maximum(s, -1.0 + 1e-7))
    return s


@functools.partial(jax.jit, static_argnames=('k', 'method', 'exclude_self'))
def similar_topk(F, query_idx, k, method='cosine', exclude_self=True):
    '''Top-k most-similar rows of F for each query index.
    Returns (idx[B, k], sims[B, k]).'''
    q = F[query_idx]
    s = similarity_to_queries(F, q, method=method)
    if exclude_self:
        n = F.shape[0]
        onehot = query_idx[:, None] == jnp.arange(n)[None, :]
        s = jnp.where(onehot, NEG, s)
    sims, idx = jax.lax.top_k(s, k)
    return idx, sims


@functools.partial(jax.jit, static_argnames=('k', 'method', 'block'))
def all_pairs_topk(F, k, method='cosine', block=1024):
    '''All-rows top-k similarity cache, computed blocked (replaces
    ``_compute_items_similarities``/``_compute_users_similarities``
    ``base.py:1192-1221``).  Returns (idx[n, k], sims[n, k]).'''
    n = F.shape[0]
    nb = -(-n // block)
    Fq, method2 = _prep(F, method)
    # pad to a block multiple: dynamic_slice clamps OOB starts, which would
    # silently re-read earlier rows in the final block
    Fp = jnp.pad(Fq, ((0, nb * block - n), (0, 0)))

    def do_block(b):
        start = b * block
        rows = jax.lax.dynamic_slice_in_dim(Fp, start, block, 0)
        if method2 == 'euclidean':
            d2 = ((rows[:, None, :] - Fq[None, :, :]) ** 2).sum(-1)
            s = -jnp.sqrt(jnp.maximum(d2, 0.0))
        else:
            s = rows @ Fq.T
            if method in ('cosine_log', 'norm_cosine'):
                s = jnp.log1p(jnp.maximum(s, -1.0 + 1e-7))
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
        valid = ids < n
        self_mask = jnp.arange(n)[None, :] == ids
        s = jnp.where(self_mask | ~valid, NEG, s)
        sims, idx = jax.lax.top_k(s, k)
        return sims, idx

    sims, idx = jax.lax.map(do_block, jnp.arange(nb))
    return (idx.reshape(nb * block, k)[:n],
            sims.reshape(nb * block, k)[:n])


@functools.partial(jax.jit, static_argnames=('k',))
def binary_cosine_topk(B, query_idx, k):
    '''Binary (rated-set) cosine similarity top-k: one matmul over the 0/1
    ratings-indicator matrix B [U, I] (replaces the per-pair python set
    intersections of ``knn_users.py:60-136``).'''
    counts = B.sum(1)
    inter = B[query_idx] @ B.T                        # [Bq, U]
    denom = jnp.sqrt(jnp.maximum(counts[query_idx][:, None] * counts[None, :],
                                 1e-12))
    s = inter / denom
    n = B.shape[0]
    onehot = query_idx[:, None] == jnp.arange(n)[None, :]
    s = jnp.where(onehot, NEG, s)
    sims, idx = jax.lax.top_k(s, k)
    return idx, sims


def numpy_reference_similarity(A, B, method='cosine'):
    '''Slow per-pair oracle used in tests (mirrors ``base.py:1247-1270``).'''
    if method == 'cosine':
        ip = float(np.inner(A, B))
        if ip == 0:
            return 0.0
        return ip / (np.linalg.norm(A) * np.linalg.norm(B))
    if method == 'pearson':
        Ac, Bc = A - A.mean(), B - B.mean()
        den = np.linalg.norm(Ac) * np.linalg.norm(Bc)
        return float(Ac @ Bc / den) if den else 0.0
    if method == 'euclidean':
        return -float(np.linalg.norm(A - B))
    raise ValueError(method)
