'''
Top-N retrieval: blocked P@Q^T scoring with fused top-k and rated-masking.

Replaces the per-candidate python scoring loop of the reference
(``mf.py:144-193`` and ``base.py:899-927``) with a single matmul per
item block and a running top-k merge, so the full score matrix never hits
HBM at once.
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -3.0e38


@functools.partial(jax.jit, static_argnames=('n', 'block', 'predictor'))
def topn_scores(P_rows, Q, bu_rows, bi, mu, rated_idx, rated_mask, n,
                block=4096, predictor='dot_plus_one', lo=1.0, hi=5.0):
    '''Top-n items for a batch of users.

    P_rows: [B, k] user factors; Q: [I, k]; bu_rows: [B]; bi: [I];
    rated_idx/rated_mask: [B, L] padded per-user rated-item lists (those
    items are excluded, like ``already_rated`` in ``mf.py:161-173``).
    predictor:
      'dot_plus_one' -> dot + 1.0          (gradient_descent.py:621-631)
      'dot'          -> plain dot           (wrmf.py:67-69)
      'bias'         -> mu + bu + bi + dot  (gradient_descent.py:637-648)
      'logistic'     -> lo + sigmoid(dot + bu + bi) * (hi - lo)
                                            (kmf.py:79-85)
    Returns (idx[B, n], scores[B, n]) sorted descending.
    '''
    B = P_rows.shape[0]
    I = Q.shape[0]
    nblocks = -(-I // block)
    Ipad = nblocks * block
    Qp = jnp.pad(Q, ((0, Ipad - I), (0, 0)))
    bip = jnp.pad(bi, (0, Ipad - I))

    def scan_block(carry, b):
        best_s, best_i = carry
        start = b * block
        qb = jax.lax.dynamic_slice_in_dim(Qp, start, block, 0)
        dot = P_rows @ qb.T                              # [B, block]
        if predictor == 'dot_plus_one':
            s = dot + 1.0
        elif predictor == 'dot':
            s = dot
        elif predictor == 'bias':
            s = mu + bu_rows[:, None] + \
                jax.lax.dynamic_slice_in_dim(bip, start, block)[None, :] + dot
        elif predictor == 'logistic':
            z = dot + bu_rows[:, None] + \
                jax.lax.dynamic_slice_in_dim(bip, start, block)[None, :]
            s = lo + jax.nn.sigmoid(z) * (hi - lo)
        else:
            raise ValueError(predictor)
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, block), 1)
        s = jnp.where(ids < I, s, NEG)
        # mask this user's already-rated items that fall in this block
        hit = (rated_idx[:, :, None] == ids[:, None, :]) \
            & (rated_mask[:, :, None] > 0)
        s = jnp.where(hit.any(1), NEG, s)
        cat_s = jnp.concatenate([best_s, s], axis=1)
        cat_i = jnp.concatenate([best_i, ids], axis=1)
        top_s, pos = jax.lax.top_k(cat_s, n)
        top_i = jnp.take_along_axis(cat_i, pos, axis=1)
        return (top_s, top_i), None

    init = (jnp.full((B, n), NEG, P_rows.dtype),
            jnp.zeros((B, n), jnp.int32))
    (scores, idx), _ = jax.lax.scan(scan_block, init, jnp.arange(nblocks))
    return idx, scores


def pad_rated_lists(ratings, user_indices, cap=None, pad_to=None):
    '''Host-side: padded already-rated lists for a batch of users —
    vectorized grid fill (no per-user python loop).  ``pad_to`` pads the
    list width UP to a fixed value (serving: one compiled shape across
    all batch compositions instead of one per batch-max rated count).'''
    from mfrec_tpu.data.ratings import padded_segment_gather
    ptr, items, _ = ratings.csr()
    users = np.asarray(user_indices, np.int64)
    counts = ptr[users + 1] - ptr[users]
    L = int(max(counts.max() if counts.size else 0, 1))
    # L policy: round up to a power of two — downstream kernels are
    # jitted on L, so shape-stable pads avoid a recompile per novel
    # batch composition (a serving-path requirement)
    L = 1 << (L - 1).bit_length()
    if cap is not None:
        L = min(L, int(cap))
    if pad_to is not None:
        # pad_to AFTER cap: the fixed serving width is a shape contract
        # (one compiled program); a cap must never silently undercut it
        L = max(L, int(pad_to))
    idx, mask = padded_segment_gather(ptr, users, L, items)
    return idx, mask
