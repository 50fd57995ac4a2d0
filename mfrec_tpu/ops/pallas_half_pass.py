'''
Pallas kernel (Triton route, for NVIDIA GPUs): a whole sorted-window
half-pass of the alternating engine in one launch.

During a half-pass the fixed side is frozen, and the sorted-window layout
(``sgd_mf.sorted_pass_layout``) puts each factor row's ratings in one
contiguous run per batch, padding last with mask 0.  A row therefore
depends only on its own runs: batch b gives it T sweeps over its run in
b, and a row split across consecutive batches carries its value from one
batch to the next.  Rows never interact.  So the kernel runs ONE PROGRAM
PER FACTOR ROW for the whole half-pass (no sequential grid over
batches).  A program

  * loads its row in float32 (k padded to a power of two and masked),
  * for each batch holding a run of it, in batch order, walks the run in
    power-of-two tiles, gathering the fixed-side rows by index straight
    from the fixed factor matrix (bfloat16 when the caller casts it — the
    accepted mixed-precision deviation of the alternating tier), and
    runs all T sweeps with the row held in registers,
  * writes the row back once, with its own SSE (the sweep-0 residual of
    each of its runs).

XLA sums the per-row SSE partials, so no atomics are needed and the sum
is deterministic.  The run offsets are computed outside the kernel.

The math is that of the XLA sweeps in ``sgd_mf.window_half_pass_xla``:
prediction ``1 + dot`` (``bias_none``) or ``mu + dot`` with optional
clamping, or the logistic link ``lo + sigmoid(dot) * (hi - lo)``; per
sweep the row steps by ``lrv * (sum_err_ff / cnt - regv * row)`` with
``row_mean`` (``sum_err_ff - regv * row * cnt`` without).  The kernel
accumulates the error term in float32 (the XLA path rounds it to
bfloat16 before its one-hot matmul), so the two agree to bf16 rounding.
'''
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 64            # batch slots per tile (power of two)
NUM_WARPS = 4


def _kernel(T, tile, B, W, link, clamp_pred, lo_r, hi_r, row_mean,
            bias_none, mu_ref, fupd_ref, ffix_ref, fix_ref, r_ref, lo_ref,
            start_ref, len_ref, first_ref, nseg_ref, lrv_ref, regv_ref,
            out_ref, sse_ref):
    g = pl.program_id(0)
    kdim = ffix_ref.shape[1]
    cols = jnp.arange(pl.next_power_of_2(kdim))
    cmask = cols < kdim
    offs = jnp.arange(tile)
    row = plgpu.load(fupd_ref.at[g * kdim + cols], mask=cmask, other=0.0)
    lrv = plgpu.load(lrv_ref.at[cols], mask=cmask, other=0.0)
    regv = plgpu.load(regv_ref.at[cols], mask=cmask, other=0.0)
    base = 1.0 if bias_none else mu_ref[0]
    rng_w = hi_r - lo_r

    def run(j, carry):
        '''T sweeps over this row's run in batch ``first + j``.'''
        row, sse_row = carry
        b = first_ref[g] + j
        bw = b * W + (g - lo_ref[b])
        start = b * B + start_ref[bw]
        n = len_ref[bw]
        cnt = n.astype(jnp.float32)

        def sweep(t, carry):
            row, sse0 = carry

            def tile_step(i, acc_sse):
                acc, sse = acc_sse
                slots = start + i * tile + offs
                smask = slots < start + n
                fix = plgpu.load(fix_ref.at[slots], mask=smask, other=0)
                r = plgpu.load(r_ref.at[slots], mask=smask, other=0.0)
                ff = plgpu.load(ffix_ref.at[fix[:, None], cols[None, :]],
                                mask=smask[:, None] & cmask[None, :],
                                other=0.0).astype(jnp.float32)
                dot = (ff * row[None, :]).sum(axis=1)
                if link == 'logistic':
                    sig = 1.0 / (1.0 + jnp.exp(-dot))
                    err = jnp.where(smask, r - (lo_r + sig * rng_w), 0.0)
                    eff = err * sig * (1.0 - sig) * rng_w
                else:
                    pred = base + dot
                    if clamp_pred:
                        pred = jnp.minimum(jnp.maximum(pred, lo_r), hi_r)
                    err = jnp.where(smask, r - pred, 0.0)
                    eff = err
                acc = acc + (eff[:, None] * ff).sum(axis=0)
                return acc, sse + (err * err).sum()

            acc, sse = lax.fori_loop(
                0, (n + tile - 1) // tile, tile_step,
                (jnp.zeros(cols.shape, jnp.float32), jnp.float32(0.0)))
            if row_mean:
                step = acc / cnt - regv * row
            else:
                step = acc - regv * row * cnt
            return row + lrv * step, jnp.where(t == 0, sse, sse0)

        row, sse0 = lax.fori_loop(0, T, sweep, (row, jnp.float32(0.0)))
        return row, sse_row + sse0

    row, sse_row = lax.fori_loop(0, nseg_ref[g], run,
                                 (row, jnp.float32(0.0)))
    plgpu.store(out_ref.at[g * kdim + cols], row, mask=cmask)
    sse_ref[g] = sse_row


def run_offsets(kl, m, W):
    '''Start and length of each window row's run in every batch of a
    sorted-window layout ([nb, B]): valid slots (m > 0) come first,
    grouped by window-local row id ``kl`` in ascending order; masked
    slots belong to no run.  Returns ([nb, W], [nb, W]) int32.'''
    klm = jnp.where(m > 0, kl, W).astype(jnp.int32)
    bounds = jax.vmap(lambda k: jnp.searchsorted(
        k, jnp.arange(W + 1, dtype=jnp.int32), side='left'))(klm)
    bounds = bounds.astype(jnp.int32)
    return bounds[:, :W], bounds[:, 1:] - bounds[:, :W]


def row_runs(lo, lens, n_rows):
    '''For every factor row: the first batch holding a run of it and the
    number of (consecutive) batches that do.'''
    nb, W = lens.shape
    rows = (lo[:, None] + jnp.arange(W, dtype=lo.dtype)[None, :]).ravel()
    has = (lens > 0).ravel()
    b = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[:, None],
                         (nb, W)).ravel()
    first = jnp.full((n_rows,), nb, jnp.int32).at[rows].min(
        jnp.where(has, b, nb))
    nseg = jnp.zeros((n_rows,), jnp.int32).at[rows].add(
        has.astype(jnp.int32))
    return jnp.where(nseg > 0, first, 0), nseg


@functools.partial(jax.jit, static_argnames=(
    'W', 'inner_steps', 'link', 'clamp_pred', 'lo_r', 'hi_r', 'row_mean',
    'bias_none', 'tile', 'num_warps', 'interpret'))
def half_pass(F_upd, F_fix, fix, r, m, kl, lo, lrv, regv, mu, *, W,
              inner_steps=1, link='identity', clamp_pred=True, lo_r=1.0,
              hi_r=5.0, row_mean=True, bias_none=False, tile=TILE,
              num_warps=NUM_WARPS, interpret=False):
    '''One sorted-window half-pass, T = ``inner_steps`` sweeps per batch.

    F_upd [R, k] float32 rows being trained (R >= every lo + W); F_fix
    [N, k] fixed-side factors (float32 or bfloat16); fix/r/m/kl [nb, B]:
    fixed-side row ids, ratings, 0/1 mask and window-local row ids of
    each batch (``sorted_pass_layout`` order); lo [nb] window starts;
    lrv/regv [k] per-column learning rates and regularization.  Returns
    (F_upd trained, SSE of the sweep-0 residuals).'''
    R, kdim = F_upd.shape
    nb, B = r.shape
    starts, lens = run_offsets(kl, m, W)
    lo = lo.astype(jnp.int32)
    first, nseg = row_runs(lo, lens, R)
    kernel = functools.partial(
        _kernel, int(inner_steps), int(tile), int(B), int(W), link,
        bool(clamp_pred), float(lo_r), float(hi_r), bool(row_mean),
        bool(bias_none))
    out, sse = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((R * kdim,), jnp.float32),
                   jax.ShapeDtypeStruct((R,), jnp.float32)),
        grid=(R,),
        compiler_params=plgpu.CompilerParams(num_warps=int(num_warps)),
        interpret=interpret,
        backend='triton',
        name='sorted_half_pass',
    )(jnp.reshape(jnp.asarray(mu, jnp.float32), (1,)),
      F_upd.astype(jnp.float32).reshape(-1), F_fix,
      fix.astype(jnp.int32).reshape(-1), r.astype(jnp.float32).reshape(-1),
      lo, starts.reshape(-1), lens.reshape(-1), first, nseg,
      lrv.astype(jnp.float32), regv.astype(jnp.float32))
    return out.reshape(R, kdim), sse.sum()
