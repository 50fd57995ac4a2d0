'''
Sharded WRMF ALS.

Per half-sweep the rows are embarrassingly parallel (SURVEY.md §2.5): the
updated side is row-sharded over the mesh, the fixed side is replicated
(its Gram HH is computed locally — it is tiny, [k, k]).  Between
half-sweeps the freshly-updated side is all-gathered to become the next
fixed side.  Uses a uniform-L padded layout so every shard has identical
shapes (trades padding memory for shard-uniformity; the single-chip
nnz-bucket ladder of ``ops.als`` stays the memory-lean option).

Reachable from the public model API: ``WRMFRecommender`` with
``engine='als_sharded'`` (or the default ``'auto'`` on >1 device); both
the exact batched-Cholesky solver and the warm-started Jacobi-PCG fast
path (``solver='cg'``) run sharded.  Reference seed:
``als_implicit.pyx:211-352`` (per-row normal equations).
'''
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map


def padded_uniform(ratings, axis, D):
    '''Uniform-L padded neighbor lists, padded to D-divisible row count.
    Returns (nbr_idx [R, L], nbr_val [R, L], mask [R, L]).'''
    if axis == 'user':
        ptr, nbr, val = ratings.csr()
        nrows = ratings.nbr_users
    else:
        ptr, nbr, val = ratings.csc()
        nrows = ratings.nbr_items
    counts = np.diff(ptr)
    L = max(int(counts.max()) if counts.size else 1, 1)
    R = -(-nrows // D) * D
    idx = np.zeros((R, L), np.int32)
    vals = np.zeros((R, L), np.float32)
    mask = np.zeros((R, L), np.float32)
    # vectorized grid fill (no per-row python loop)
    cnts = counts[:, None]                              # [nrows, 1]
    offs = np.arange(L, dtype=np.int64)[None, :]        # [1, L]
    m = offs < cnts
    grid = ptr[:-1][:, None] + np.minimum(offs, np.maximum(cnts - 1, 0))
    grid = np.minimum(grid, max(nbr.shape[0] - 1, 0))
    if nbr.shape[0]:
        idx[:nrows] = nbr[grid] * m
        vals[:nrows] = val[grid] * m
        mask[:nrows] = m
    return idx, vals, mask


def make_sharded_als_epoch(mesh, c_pos=1.0, alpha=0.0, reg=0.015,
                           axis='dp', solver='exact', cg_steps=6,
                           gram_dtype=None):
    '''Build a jitted sharded ALS epoch:

        (P, Q, u_idx, u_val, u_mask, i_idx, i_val, i_mask) -> (P, Q)

    P [Up, k] row-sharded, Q [Ip, k] row-sharded; neighbor-list tensors
    row-sharded to match their side.  Each half-sweep all-gathers the
    fixed side (one all_gather), computes HH locally, then runs the
    batched normal-equation solve on the local rows.

    ``solver='cg'``: warm-started Jacobi-PCG (``ops.als.pcg_solve``)
    instead of the exact Cholesky — the same fast path as the
    single-device tier, now over the mesh.  ``gram_dtype`` (e.g.
    ``jnp.bfloat16``) runs the rank-L Gram corrections with bf16 inputs
    and f32 accumulation; the CG path always uses bf16 Gram like the
    single-device ``_bucket_cg_body``.
    '''

    def solve_rows(F_fixed, x0, nbr_idx, nbr_val, mask):
        from mfrec_tpu.ops.als import pcg_solve
        k = F_fixed.shape[1]
        HH = (F_fixed.T @ F_fixed).astype(jnp.float32)
        cm1 = jnp.where(alpha > 0, alpha * nbr_val, c_pos) * mask
        if solver == 'cg':
            # bf16 gather, like the single-chip CG tier (ops.als
            # _bucket_cg_body): the neighbor gather moves half the
            # bytes; mask rides the contraction weights
            Ab = F_fixed.astype(jnp.bfloat16)[nbr_idx]
            Aw = Ab * cm1[..., None].astype(jnp.bfloat16)
            M = HH[None] + jnp.einsum('rlk,rlm->rkm', Aw, Ab,
                                      preferred_element_type=jnp.float32)
            b = jnp.einsum('rl,rlk->rk', (1.0 + cm1) * mask, Ab,
                           preferred_element_type=jnp.float32)
        else:
            A = F_fixed[nbr_idx] * mask[..., None]
            gd = gram_dtype
            Ag = A if gd is None else A.astype(gd)
            Aw = (A * cm1[..., None]) if gd is None \
                else (A * cm1[..., None]).astype(gd)
            M = HH[None] + jnp.einsum('rlk,rlm->rkm', Aw, Ag,
                                      preferred_element_type=jnp.float32)
            b = ((1.0 + cm1)[..., None] * A).sum(1)
        M = M + reg * jnp.eye(k, dtype=jnp.float32)[None]
        # rows with no neighbors solve to 0 in the reference
        # (als_implicit.pyx:296-302, b = 0); force it exactly so their
        # residue never leaks into the next half-sweep's Gram (CG only
        # drives them NEAR zero from a warm start)
        alive = (mask.sum(1) > 0).astype(jnp.float32)[:, None]
        if solver == 'cg':
            return pcg_solve(M, b, x0, int(cg_steps)) * alive
        L = jnp.linalg.cholesky(M)
        sol = jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
        return sol * alive

    def device_fn(P, Q, u_idx, u_val, u_mask, i_idx, i_val, i_mask):
        Q_full = jax.lax.all_gather(Q, axis, tiled=True)
        P = solve_rows(Q_full, P, u_idx, u_val, u_mask).astype(P.dtype)
        P_full = jax.lax.all_gather(P, axis, tiled=True)
        Q = solve_rows(P_full, Q, i_idx, i_val, i_mask).astype(Q.dtype)
        return P, Q

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PS(axis),) * 8,
        out_specs=(PS(axis), PS(axis)),
        check_vma=False)
    return jax.jit(sharded)
