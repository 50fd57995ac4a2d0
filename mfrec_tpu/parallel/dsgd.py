'''
Distributed SGD matrix factorization over a device mesh.

Two schemes, both pure-JAX collectives (no custom transport):

* **Ring DSGD** (Gemulla et al. KDD'11 diagonal-block schedule): users and
  items are partitioned into D blocks.  Device d owns user-block d
  permanently and item-block (d+s) mod D at step s; at each of the D steps
  every device trains the ratings of its (user-block, current item-block)
  cell — the D cells of a diagonal touch disjoint P/Q tiles, so there are
  no write conflicts — then the Q shards rotate one hop around the ring
  via ``ppermute``.  After D steps every rating has been visited once:
  one full epoch, factors fully sharded, communication = D Q-shard hops
  between neighbors.

* **Zinkevich parameter averaging** (the production version of the
  reference's two-machine simulation, ``gradient_descent.py:124-211``):
  ratings sharded, factors replicated; each device runs a local epoch and
  factors are ``pmean``-averaged.

Host-side layout: ``build_dsgd_blocks`` pre-buckets the COO ratings into
the [D, D] block grid with local indices and padding.
'''
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops.sgd_mf import clamp


def build_dsgd_blocks(uidx, iidx, vals, D, nbr_users, nbr_items, seed=0):
    '''Partition COO ratings into the [D, D] (user-block, item-block) grid.

    Returns ((ub, ib, rb, mb), (Ub, Ib)): block tensors of shape
    [D, D, npad] holding LOCAL row indices within the owning P/Q shard,
    padded to the largest cell; Ub/Ib are rows per user/item shard.
    Rows are shuffled within each cell (deterministic seed).
    '''
    Ub = -(-nbr_users // D)
    Ib = -(-nbr_items // D)
    ublock = uidx // Ub
    iblock = iidx // Ib
    rng = np.random.default_rng(seed)
    cells = {}
    npad = 1
    for du in range(D):
        for di in range(D):
            sel = np.nonzero((ublock == du) & (iblock == di))[0]
            rng.shuffle(sel)
            cells[(du, di)] = sel
            npad = max(npad, sel.shape[0])
    ub = np.zeros((D, D, npad), np.int32)
    ib = np.zeros((D, D, npad), np.int32)
    rb = np.zeros((D, D, npad), np.float32)
    mb = np.zeros((D, D, npad), np.float32)
    for du in range(D):
        for di in range(D):
            sel = cells[(du, di)]
            n = sel.shape[0]
            # stored at [du, di]: device du processes this cell at step
            # s = (di - du) mod D, when it holds item-block di
            ub[du, di, :n] = uidx[sel] - du * Ub
            ib[du, di, :n] = iidx[sel] - di * Ib
            rb[du, di, :n] = vals[sel]
            mb[du, di, :n] = 1.0
    return (ub, ib, rb, mb), (Ub, Ib)


def pad_factors(F, rows_per_shard, D):
    '''Pad a [n, ...] factor array to D * rows_per_shard rows.'''
    pad = D * rows_per_shard - F.shape[0]
    width = [(0, pad)] + [(0, 0)] * (F.ndim - 1)
    return np.pad(np.asarray(F), width)


def make_ring_dsgd_epoch(mesh, lr, K, bias_mode='fixed', clamp_pred=True,
                         lo=1.0, hi=5.0, axis='dp'):
    '''Build a jitted sharded epoch:

        (P, Q, bu, bi, mu, ub, ib, rb, mb) -> (P, Q, bu, bi, rmse)

    P [D*Ub, k] and bu [D*Ub] row-sharded by user-block; Q [D*Ib, k] and
    bi [D*Ib] row-sharded by item-block; block tensors [D, D, npad]
    sharded along their first (user-block) axis; mu replicated.
    '''
    D = mesh.devices.size

    def device_fn(P, Q, bu, bi, mu, ub, ib, rb, mb):
        # local shapes: P [Ub, k]; Q [Ib, k]; bu [Ub]; bi [Ib];
        # ub/ib/rb/mb [1, D, npad]
        d = jax.lax.axis_index(axis)
        ub, ib, rb, mb = ub[0], ib[0], rb[0], mb[0]

        def step(s, carry):
            P, Q, bu, bi, sse = carry
            blk = (d + s) % D            # item-block currently held
            u = jnp.take(ub, blk, axis=0)
            i = jnp.take(ib, blk, axis=0)
            r = jnp.take(rb, blk, axis=0)
            m = jnp.take(mb, blk, axis=0)
            pu = P[u]
            qi = Q[i]
            dot = (pu * qi).sum(-1)
            if bias_mode == 'none':
                pred = 1.0 + dot
            else:
                pred = mu + bu[u] + bi[i] + dot
            if clamp_pred:
                pred = clamp(pred, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            P = P.at[u].add(lr * (err[:, None] * qi - K * pu * m[:, None]))
            Q = Q.at[i].add(lr * (err[:, None] * pu - K * qi * m[:, None]))
            # rotate item shards one hop: device j's Q goes to device j-1
            perm = [(j, (j - 1) % D) for j in range(D)]
            Q = jax.lax.ppermute(Q, axis, perm)
            bi2 = jax.lax.ppermute(bi, axis, perm)
            return P, Q, bu, bi2, sse

        P, Q, bu, bi, sse = jax.lax.fori_loop(
            0, D, step, (P, Q, bu, bi, jnp.zeros((), P.dtype)))
        total_sse = jax.lax.psum(sse, axis)
        n = jax.lax.psum(mb.sum(), axis)
        rmse = jnp.sqrt(total_sse / jnp.maximum(n, 1.0))
        return P, Q, bu, bi, rmse

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PS(axis), PS(axis), PS(axis), PS(axis), PS(),
                  PS(axis), PS(axis), PS(axis), PS(axis)),
        out_specs=(PS(axis), PS(axis), PS(axis), PS(axis), PS()),
        check_vma=False)
    return jax.jit(sharded)


def make_zinkevich_epoch(mesh, lr, K, bias_mode='none', clamp_pred=True,
                         lo=1.0, hi=5.0, axis='dp'):
    '''Parameter-averaged data-parallel epoch: each device sweeps its
    rating shard against a full factor replica, then factors are averaged
    (``psum``/D) — Zinkevich et al., Parallelized SGD (NeurIPS 2010);
    production form of reference ``gradient_descent.py:124-211``.'''
    D = mesh.devices.size

    def device_fn(P, Q, mu, ub, ib, rb, mb):
        u, i, r, m = ub[0], ib[0], rb[0], mb[0]
        pu = P[u]
        qi = Q[i]
        dot = (pu * qi).sum(-1)
        pred = (1.0 + dot) if bias_mode == 'none' else (mu + dot)
        if clamp_pred:
            pred = clamp(pred, lo, hi)
        err = (r - pred) * m
        sse = jax.lax.psum((err * err).sum(), axis)
        n = jax.lax.psum(m.sum(), axis)
        P = P.at[u].add(lr * (err[:, None] * qi - K * pu * m[:, None]))
        Q = Q.at[i].add(lr * (err[:, None] * pu - K * qi * m[:, None]))
        # communication happens only here: one factor average per epoch
        P = jax.lax.psum(P, axis) / D
        Q = jax.lax.psum(Q, axis) / D
        return P, Q, jnp.sqrt(sse / jnp.maximum(n, 1.0))

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PS(), PS(), PS(), PS(axis), PS(axis), PS(axis), PS(axis)),
        out_specs=(PS(), PS(), PS()),
        check_vma=False)
    return jax.jit(sharded)


def shard_ratings_for_averaging(uidx, iidx, vals, D, seed=0):
    '''Split shuffled COO ratings into D equal padded shards
    [D, npad] (leading axis row-sharded).'''
    n = uidx.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    uidx, iidx, vals = uidx[perm], iidx[perm], vals[perm]
    npad = -(-n // D)
    tot = npad * D
    pad = tot - n
    ub = np.pad(uidx, (0, pad)).reshape(D, npad).astype(np.int32)
    ib = np.pad(iidx, (0, pad)).reshape(D, npad).astype(np.int32)
    rb = np.pad(vals, (0, pad)).reshape(D, npad).astype(np.float32)
    mb = np.pad(np.ones(n, np.float32), (0, pad)).reshape(D, npad)
    return ub, ib, rb, mb
