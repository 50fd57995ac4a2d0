'''
Ring-rotation multi-chip alternating SGD — all_gather-free factor flow.

The sharded alternating engine (``parallel.alternating_sharded``) gathers
the full read-side factor array once per half-pass: every device holds a
replica of Q during the P pass (and of P during the Q pass).  Total
bytes moved per half-pass are (D-1)/D * |Q| per device either way, but the
replica costs |Q| of device memory per device — the wall once the item catalog is
production-sized (10M items x rank 64 = 2.5 GB per device as a replica,
vs 2/D of that for a rotating shard pair).

This engine never materializes the replica.  Each device keeps only its
OWN read-side shard resident and the ratings are grouped by the
read-side shard they touch: in round s, device d processes the ratings
whose items live in shard (d + s) mod D, then passes the resident shard
one hop around the ring (``jax.lax.ppermute``) — the Gemulla DSGD
diagonal schedule applied to the sorted-window engine's read side.
After D rounds every rating has been visited and the shard is home.

  round s:  device d holds read shard c = (d + s) mod D
            trains its key-side rows against c's rows only
            sends c to device (d - 1) mod D  (receives from d + 1)

Update-side windows are untouched: keys stay sorted within each round's
batches, so the scatter-free one-hot window aggregation of
``ops.sgd_mf.make_alternating_epoch`` runs unchanged.  The update order
within a device differs from the all_gather engine (round-major instead
of fully user-sorted), so parity with it is RMSE-level, not bitwise —
the same contract as every order-changing parallel tier (see
tests/test_ring_alternating.py).

Reference seed: the ring schedule generalizes the reference's only
parallel artifact, the 2-machine Zinkevich averaging prototype
(``mfrec/recommendation/gradient_descent.py:124-211``), to a
communication-optimal mesh layout; the reference itself has no
distributed backend (SURVEY.md §2.5).
'''
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax import shard_map

from mfrec_tpu.ops.sgd_mf import clamp


def _span_cap_bounds(k_sorted, W, batch_size):
    '''Batch boundaries over a sorted key array such that each batch's
    keys span < W rows (the window invariant).'''
    bounds = []
    n = k_sorted.shape[0]
    start = 0
    while start < n:
        end = min(start + batch_size, n)
        limit = int(np.searchsorted(k_sorted, k_sorted[start] + W,
                                    side='left'))
        end = min(end, max(limit, start + 1))
        bounds.append((start, end))
        start = end
    return bounds


def build_ring_alternating_layout(uidx, iidx, vals, D, nbr_users,
                                  nbr_items, batch_size=32768,
                                  max_window=256):
    '''Host-side layout for ``make_ring_alternating_epoch``.

    Groups each device's ratings by ring round (= which read-side shard
    the rating's other id lives in), sorts by key within each round, and
    span-caps into batches.  Returns (p_layout, q_layout, dims) where
    dims = (Ushard, Ishard, W) and each layout is the tuple of
    [D, D, nb, B] tensors (key-local kl, read-shard-local other ids,
    values, mask) plus [D, D, nb] window starts lo.
    '''
    W = int(max_window)
    Ushard = -(-nbr_users // D)
    Ishard = -(-nbr_items // D)

    def pack(key, other, rows_per_shard, other_rows_per_shard):
        shard_of_key = key // rows_per_shard
        shard_of_other = other // other_rows_per_shard
        per = {}
        nb_max = 1
        for d in range(D):
            sel_d = np.nonzero(shard_of_key == d)[0]
            oth_d = shard_of_other[sel_d]
            for s in range(D):
                c = (d + s) % D
                sel = sel_d[oth_d == c]
                k = key[sel]
                order = np.argsort(k, kind='stable')
                sel = sel[order]
                k = key[sel] - d * rows_per_shard        # shard-local key
                o = other[sel] - c * other_rows_per_shard  # read-local
                v = vals[sel]
                bounds = _span_cap_bounds(k, W, batch_size)
                per[d, s] = (k, o, v, bounds)
                nb_max = max(nb_max, len(bounds))
        # Size the batch dim to the largest REAL batch, not batch_size:
        # each (device, round) cell holds only ~1/D^2 of the ratings
        # spread over the shard's keys, so the W-span cap usually closes
        # batches far below batch_size — allocating batch_size would
        # inflate the layout (and the kernel's masked work) ~D-fold.
        B = 1
        for k, o, v, bounds in per.values():
            for st, e in bounds:
                B = max(B, e - st)
        kl = np.zeros((D, D, nb_max, B), np.int32)
        og = np.zeros((D, D, nb_max, B), np.int32)
        rb = np.zeros((D, D, nb_max, B), np.float32)
        mb = np.zeros((D, D, nb_max, B), np.float32)
        lo = np.zeros((D, D, nb_max), np.int32)
        for (d, s), (k, o, v, bounds) in per.items():
            for b, (st, e) in enumerate(bounds):
                m = e - st
                base = k[st]
                kl[d, s, b, :m] = k[st:e] - base
                og[d, s, b, :m] = o[st:e]
                rb[d, s, b, :m] = v[st:e]
                mb[d, s, b, :m] = 1.0
                og[d, s, b, m:] = o[st] if m else 0
                lo[d, s, b] = base
        return kl, og, rb, mb, lo

    p_layout = pack(uidx, iidx, Ushard, Ishard)
    q_layout = pack(iidx, uidx, Ishard, Ushard)
    return p_layout, q_layout, (Ushard, Ishard, W)


def make_ring_alternating_epoch(mesh, W, lr, K, bias_mode='fixed',
                                clamp_pred=True, lo_r=1.0, hi_r=5.0,
                                chunk=4096, row_mean=True, axis='dp',
                                inner_steps=1):
    '''Jitted ring epoch over augmented factors:

        (Paug, Qaug, mu, p_layout, q_layout) -> (Paug, Qaug, rmse)

    Paug: [D*(Ushard+W), k+2] row-sharded over `axis`; Qaug likewise;
    layouts from ``build_ring_alternating_layout``.  Unlike the
    all_gather engine, the read side never exists as a replica: each
    device reads one [shard+W, k+2] block that rotates one device per
    round.  Fixed-bias augmented-factor convention (bias columns frozen);
    'learned' is single-chip-engine-only, as in the sharded engine.
    '''
    if bias_mode == 'learned':
        raise NotImplementedError('learned biases on the sharded path: '
                                  'use the single-chip engine')
    D = mesh.shape[axis]
    perm = [(j, (j - 1) % D) for j in range(D)]

    def batch_step_factory(F_read, mu):
        def step(carry, batch):
            F_upd, sse = carry
            kli, ogi, r, m, lo_b = batch
            ff = F_read[ogi]
            colmask = jnp.ones((ff.shape[1],), ff.dtype)
            colmask = colmask.at[-2:].set(0.0)
            ch = min(chunk, kli.shape[0])
            pad = -kli.shape[0] % ch
            if pad:
                ff = jnp.pad(ff, ((0, pad), (0, 0)))
                kli = jnp.pad(kli, (0, pad))
                m = jnp.pad(m, (0, pad))
                r = jnp.pad(r, (0, pad))
            B = kli.shape[0]
            kc = kli.reshape(B // ch, ch)
            onehot = (kc[:, :, None] ==
                      jnp.arange(W)[None, None, :]).astype(jnp.bfloat16)
            if row_mean:
                mc = m.reshape(B // ch, ch).astype(jnp.bfloat16)
                cnt = jnp.einsum('nc,ncw->w', mc, onehot,
                                 preferred_element_type=jnp.float32)
                cnt = jnp.maximum(cnt, 1.0)[:, None]
            win = jax.lax.dynamic_slice_in_dim(F_upd, lo_b, W, 0)

            # fori_loop, not python range (see alternating_sharded)
            def sweep(t, carry):
                win, sse = carry
                fu = win[kli]
                dot = (fu * ff).sum(-1)
                pred = (1.0 + dot) if bias_mode == 'none' else (mu + dot)
                if clamp_pred:
                    pred = clamp(pred, lo_r, hi_r)
                err = (r - pred) * m
                sse = jnp.where(t == 0, sse + (err * err).sum(), sse)
                g = err[:, None] * ff - K * fu * m[:, None]
                gc = g.reshape(B // ch, ch, -1).astype(jnp.bfloat16)
                gsum = jnp.einsum('nck,ncw->wk', gc, onehot,
                                  preferred_element_type=jnp.float32)
                if row_mean:
                    gsum = gsum / cnt
                return win + lr * gsum * colmask[None, :], sse
            win, sse = jax.lax.fori_loop(0, inner_steps, sweep, (win, sse))
            F_upd = jax.lax.dynamic_update_slice_in_dim(F_upd, win, lo_b, 0)
            return (F_upd, sse), None
        return step

    def ring_half(F_upd, F_read0, mu, kl, og, rb, mb, lo):
        # local blocks [1, R, nb, B] -> [R, nb, B] (R = D rounds)
        kl, og, rb, mb = (x.reshape(x.shape[-3:]) for x in
                          (kl, og, rb, mb))
        lo = lo.reshape(lo.shape[-2:])

        def round_step(carry, round_batches):
            F_upd, F_read, sse = carry
            step = batch_step_factory(F_read, mu)
            (F_upd, sse), _ = jax.lax.scan(step, (F_upd, sse),
                                           round_batches)
            # hand the resident read shard one hop around the ring; the
            # final hop returns it home (uniform scan body, one spare
            # message per half-pass)
            F_read = jax.lax.ppermute(F_read, axis, perm)
            return (F_upd, F_read, sse), None

        (F_upd, _, sse), _ = jax.lax.scan(
            round_step, (F_upd, F_read0, jnp.zeros((), F_upd.dtype)),
            (kl, og, rb, mb, lo))
        return F_upd, sse

    def device_fn(Paug, Qaug, mu, pkl, pog, prb, pmb, plo,
                  qkl, qog, qrb, qmb, qlo):
        # read side starts as the device's OWN shard of the other factor
        Paug, sse_p = ring_half(Paug, Qaug, mu, pkl, pog, prb, pmb, plo)
        Qaug, sse_q = ring_half(Qaug, Paug, mu, qkl, qog, qrb, qmb, qlo)
        total = jax.lax.psum(sse_p + sse_q, axis)
        n = jax.lax.psum(pmb.sum() + qmb.sum(), axis)
        return Paug, Qaug, jnp.sqrt(total / jnp.maximum(n, 1.0))

    in_specs = (PS(axis), PS(axis), PS()) + (PS(axis),) * 10
    out_specs = (PS(axis), PS(axis), PS())
    sharded = shard_map(device_fn, mesh=mesh,
                        in_specs=in_specs, out_specs=out_specs,
                        check_vma=False)
    return jax.jit(sharded)
