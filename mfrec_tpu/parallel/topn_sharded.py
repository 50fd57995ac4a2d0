'''
Mesh-sharded top-N retrieval (SURVEY.md §2.5, "Top-N retrieval at scale"):
Q sharded over the ITEMS axis, per-shard blocked P@Q^T + top-k on every
device, one all_gather of the [B, n] per-shard candidates, then
a global re-rank of the [B, D*n] pool — communication is O(B*n*D), never
the score matrix.

The per-shard scorer is the single-device path (``ops.topk.topn_scores``),
so single-device and sharded results are identical by construction: the
global top-n is a subset of the union of per-shard top-ns.

Rated-item masking: global rated ids are remapped to shard-local ids on
device (valid only where the id falls in this shard's range), so masking
is exact across shards.
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops import topk as topk_ops


def pad_items_sharded(Q, bi, D):
    '''Pad Q/bi rows to a D multiple; padded rows get bi = NEG so they
    never reach a shard's top-n.  Returns (Qp, bip, Ishard).'''
    I = Q.shape[0]
    Ishard = -(-I // D)
    Ipad = Ishard * D
    Qp = np.zeros((Ipad, Q.shape[1]), np.float32)
    Qp[:I] = Q
    bip = np.full((Ipad,), topk_ops.NEG, np.float32)
    bip[:I] = bi
    return Qp, bip, Ishard


def make_sharded_topn(mesh, n, Ishard, block=1024, predictor='bias',
                      lo=1.0, hi=5.0, axis='dp'):
    '''Build the jitted sharded retrieval:

        fn(P_rows [B,k], Q [D*Ishard,k], bu [B], bi [D*Ishard], mu,
           rated_idx [B,L], rated_mask [B,L]) -> (idx [B,n], scores [B,n])

    Q/bi row-sharded over `axis`; everything else replicated; output
    replicated (global item ids, sorted descending).'''
    n = int(n)

    def device_fn(P_rows, Q_shard, bu, bi_shard, mu, rated_idx, rated_mask):
        d = jax.lax.axis_index(axis)
        offset = d * Ishard
        # rows added by pad_items_sharded carry bi = NEG; predictors
        # whose score form ignores the item bias (dot/dot_plus_one)
        # would otherwise rank them as real zero-vector items
        pad_neg = bi_shard <= topk_ops.NEG / 2
        # remap global rated ids to shard-local (out-of-shard -> mask 0)
        local = rated_idx - offset
        in_shard = (local >= 0) & (local < Ishard)
        lmask = rated_mask * in_shard
        lidx = jnp.where(in_shard, local, 0)
        idx, sc = topk_ops.topn_scores(
            P_rows, Q_shard, bu, bi_shard, mu, lidx, lmask, n,
            block=min(block, Q_shard.shape[0]), predictor=predictor,
            lo=lo, hi=hi)
        # topn_scores only masks its OWN block padding; the shard pad
        # rows score dot(+1)=0/1 under dot/dot_plus_one (and exactly `lo`
        # under logistic) and can surface as phantom ids >= nbr_items —
        # force them to NEG by bias lookup
        sc = jnp.where(pad_neg[idx], topk_ops.NEG, sc)
        idx = idx + offset
        # pool the [B, n] candidates from all shards and re-rank
        all_s = jax.lax.all_gather(sc, axis)        # [D, B, n]
        all_i = jax.lax.all_gather(idx, axis)
        D = all_s.shape[0]
        B = all_s.shape[1]
        pool_s = jnp.transpose(all_s, (1, 0, 2)).reshape(B, D * n)
        pool_i = jnp.transpose(all_i, (1, 0, 2)).reshape(B, D * n)
        top_s, pos = jax.lax.top_k(pool_s, n)
        top_i = jnp.take_along_axis(pool_i, pos, axis=1)
        return top_i, top_s

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PS(), PS(axis), PS(), PS(axis), PS(), PS(), PS()),
        out_specs=(PS(), PS()),
        check_vma=False)
    return jax.jit(sharded)


@functools.lru_cache(maxsize=8)
def _cached_sharded_topn(mesh_key, n, Ishard, block, predictor, lo, hi,
                         axis):
    from mfrec_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_key)
    return make_sharded_topn(mesh, n, Ishard, block=block,
                             predictor=predictor, lo=lo, hi=hi, axis=axis)


def sharded_topn(P_rows, Q, bu_rows, bi, mu, rated_idx, rated_mask, n,
                 block=1024, predictor='bias', lo=1.0, hi=5.0,
                 n_devices=None):
    '''Convenience wrapper: builds the mesh over all visible devices,
    pads/shards Q, and runs the sharded retrieval; padded rows are
    suppressed by NEG scores (they can only appear, NEG-scored, when a
    user has fewer than n rankable items — exactly like the block
    padding in the single-device path).  Host-facing twin of
    ``ops.topk.topn_scores`` (same return contract).'''
    D = n_devices or len(jax.devices())
    Qp, bip, Ishard = pad_items_sharded(np.asarray(Q, np.float32),
                                        np.asarray(bi, np.float32), D)
    fn = _cached_sharded_topn(D, int(n), Ishard, block, predictor,
                              float(lo), float(hi), 'dp')
    idx, sc = fn(jnp.asarray(P_rows, jnp.float32), jnp.asarray(Qp),
                 jnp.asarray(bu_rows, jnp.float32), jnp.asarray(bip),
                 jnp.float32(mu), jnp.asarray(rated_idx, jnp.int32),
                 jnp.asarray(rated_mask, jnp.float32))
    return np.asarray(idx), np.array(sc)
