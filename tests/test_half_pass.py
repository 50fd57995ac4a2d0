'''The sorted-window half-pass: the Pallas kernel (interpret mode here),
the XLA sweeps and the float64 twin (``reference_numpy.window_half_pass``)
must agree on one batch; the dispatch must pick XLA on the CPU and run
the kernel in interpret mode only when asked.'''
import pathlib
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mfrec_tpu.ops import pallas_half_pass, sgd_mf
from mfrec_tpu.ops.reference_numpy import sorted_half_pass as twin_pass

BIAS_MODES = ('none', 'fixed', 'learned')


def _layout(k, seed=0, U=40, I=30, W=16, B=128, heavy=300):
    '''A ragged user-side sorted-window layout: 0..12 ratings per user,
    one heavy user (several kernel tiles, split across batches), mask-0
    padding in every batch.  Returns (F_upd, F_fix, (fix, r, m, kl, lo),
    W) with augmented [f | b | 1] rows.'''
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 13, U)
    counts[5] = heavy
    u = np.repeat(np.arange(U), counts).astype(np.int32)
    i = rng.integers(0, I, u.size).astype(np.int32)
    v = rng.integers(1, 6, u.size).astype(np.float32)
    ub, ib, rb, mb, kl, lo, W = sgd_mf.sorted_pass_layout(
        u, i, v, B, axis='user', max_window=W)
    kdim = k + 2
    F_upd = rng.normal(0, 0.3, (U + W, kdim)).astype(np.float32)
    F_upd[:, k + 1] = 1.0                     # user rows: [p | bu | 1]
    F_fix = rng.normal(0, 0.3, (I, kdim)).astype(np.float32)
    F_fix[:, k] = 1.0                         # item rows: [q | 1 | bi]
    return F_upd, F_fix, (ib, rb, mb, kl, lo), W


def _cols(k, bias_mode):
    return sgd_mf.col_vectors(k, True, 0.1, 0.02, 0.05, 0.01,
                              learned=bias_mode == 'learned')


def _kw(link, bias_mode, T):
    return dict(inner_steps=T, link=link, clamp_pred=link == 'identity',
                lo_r=1.0, hi_r=5.0, row_mean=True,
                bias_none=bias_mode == 'none')


def _twin(F_upd, F_fix, lay, W, lrv, regv, kw):
    fix, r, m, kl, lo = lay
    return twin_pass(F_upd, F_fix, fix, r, m, kl, lo, np.asarray(lrv),
                     np.asarray(regv), 3.5, W, **kw)


def _dev(lay):
    return tuple(jnp.asarray(x) for x in lay)


def test_layout_has_a_heavy_split_row():
    '''The fixture exercises what the kernel must get right: row 5 holds
    several tiles of slots and is split across consecutive batches.'''
    _, _, (fix, r, m, kl, lo), W = _layout(8)
    per_batch = [int(((kl[b] + lo[b] == 5) & (m[b] > 0)).sum())
                 for b in range(m.shape[0])]
    spans = [b for b, c in enumerate(per_batch) if c]
    assert sum(per_batch) > 2 * pallas_half_pass.TILE
    assert len(spans) >= 2 and spans == list(range(spans[0],
                                                     spans[-1] + 1))


@pytest.mark.parametrize('k', [8, 64])
@pytest.mark.parametrize('T', [1, 4])
@pytest.mark.parametrize('bias_mode', BIAS_MODES)
@pytest.mark.parametrize('link', ['identity', 'logistic'])
def test_kernel_interpret_matches_twin(link, bias_mode, T, k):
    F_upd, F_fix, lay, W = _layout(k, seed=T + k)
    lrv, regv = _cols(k, bias_mode)
    kw = _kw(link, bias_mode, T)
    got, sse = pallas_half_pass.half_pass(
        jnp.asarray(F_upd), jnp.asarray(F_fix), *_dev(lay), lrv, regv, 3.5,
        W=W, interpret=True, **kw)
    want, sse_want = _twin(F_upd, F_fix, lay, W, lrv, regv, kw)
    # float32 arithmetic vs the float64 twin, sums in another order
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(sse), sse_want, rtol=1e-5)


@pytest.mark.parametrize('T', [1, 4])
@pytest.mark.parametrize('bias_mode', BIAS_MODES)
@pytest.mark.parametrize('link', ['identity', 'logistic'])
def test_xla_half_pass_matches_twin(link, bias_mode, T):
    k = 8
    F_upd, F_fix, lay, W = _layout(k, seed=T)
    lrv, regv = _cols(k, bias_mode)
    kw = _kw(link, bias_mode, T)
    got, sse = sgd_mf.sorted_half_pass(
        jnp.asarray(F_upd), jnp.asarray(F_fix), *_dev(lay), lrv, regv, 3.5,
        W=W, chunk=64, kernel=False, **kw)
    want, sse_want = _twin(F_upd, F_fix, lay, W, lrv, regv, kw)
    # the XLA sweeps aggregate bf16-rounded gradients (f32 accumulation):
    # a step moves by lr * g, so the window error is ~lr * 2^-8 * |g|
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(float(sse), sse_want, rtol=1e-5)


def test_kernel_bf16_fixed_side_matches_twin():
    '''The bfloat16 fixed side (``ff_dtype='bfloat16'``) is upcast before
    the arithmetic: the kernel equals the twin fed the rounded rows.'''
    F_upd, F_fix, lay, W = _layout(64, seed=5)
    lrv, regv = _cols(64, 'fixed')
    kw = _kw('identity', 'fixed', 4)
    Fb = jnp.asarray(F_fix, jnp.bfloat16)
    got, _ = pallas_half_pass.half_pass(
        jnp.asarray(F_upd), Fb, *_dev(lay), lrv, regv, 3.5, W=W,
        interpret=True, **kw)
    want, _ = _twin(F_upd, np.asarray(Fb, np.float32), lay, W, lrv, regv,
                    kw)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_run_offsets_and_row_runs_match_numpy():
    F_upd, _, (fix, r, m, kl, lo), W = _layout(8, seed=3)
    starts, lens = pallas_half_pass.run_offsets(jnp.asarray(kl),
                                                jnp.asarray(m), W)
    first, nseg = pallas_half_pass.row_runs(jnp.asarray(lo), lens,
                                            F_upd.shape[0])
    want_first = {}
    want_nseg = np.zeros(F_upd.shape[0], np.int64)
    for b in range(m.shape[0]):
        cnt = np.bincount(kl[b][m[b] > 0], minlength=W)
        np.testing.assert_array_equal(np.asarray(lens[b]), cnt)
        np.testing.assert_array_equal(np.asarray(starts[b]),
                                      np.cumsum(cnt) - cnt)
        for w in np.nonzero(cnt)[0]:
            want_first.setdefault(lo[b] + w, b)
            want_nseg[lo[b] + w] += 1
    np.testing.assert_array_equal(np.asarray(nseg), want_nseg)
    for g, b in want_first.items():
        assert int(first[g]) == b


def test_sorted_pass_layout_meets_kernel_contract():
    '''Valid slots first, each window row's run contiguous and ascending
    — what the kernel's run offsets assume.'''
    rng = np.random.default_rng(1)
    u = rng.integers(0, 90, 3000).astype(np.int32)
    i = rng.integers(0, 40, 3000).astype(np.int32)
    v = rng.integers(1, 6, 3000).astype(np.float32)
    for axis in ('user', 'item'):
        ub, ib, rb, mb, kl, lo, W = sgd_mf.sorted_pass_layout(
            u, i, v, 256, axis=axis, max_window=16)
        for b in range(mb.shape[0]):
            nv = int(mb[b].sum())
            assert (mb[b, :nv] == 1).all() and (mb[b, nv:] == 0).all()
            assert (np.diff(kl[b, :nv]) >= 0).all()
            assert kl[b, :nv].max() < W


# ------------------------------------------------------- kernel choice
def test_cpu_picks_xla():
    assert jax.default_backend() == 'cpu'
    assert sgd_mf.half_pass_kernel_default() is False


@pytest.mark.parametrize('kernel,expect_calls', [(None, 0), (False, 0),
                                                 (True, 1)])
def test_sorted_half_pass_dispatch(monkeypatch, kernel, expect_calls):
    '''Default (None) follows the platform; the kernel gets interpret=False
    unless the caller asks.'''
    calls = []
    real = pallas_half_pass.half_pass

    def spy(*a, **kw):
        calls.append(kw['interpret'])
        return real(*a, **dict(kw, interpret=True))

    monkeypatch.setattr(pallas_half_pass, 'half_pass', spy)
    F_upd, F_fix, lay, W = _layout(8)
    lrv, regv = _cols(8, 'fixed')
    sgd_mf.sorted_half_pass(jnp.asarray(F_upd), jnp.asarray(F_fix),
                            *_dev(lay), lrv, regv, 3.5, W=W, chunk=64,
                            kernel=kernel)
    assert calls == [False] * expect_calls


def test_no_backend_chosen_interpret_in_package():
    root = pathlib.Path(sgd_mf.__file__).resolve().parents[1]
    bad = re.compile(r"interpret\s*=\s*[^,)\n]*default_backend|"
                     r"default_backend\(\)\s*!=\s*'cpu'")
    hits = [str(p) for p in root.rglob('*.py') if bad.search(p.read_text())]
    assert hits == []


def _tiny_layouts(seed=2, U=70, I=50, n=1500, batch=128, W=16):
    from mfrec_tpu.data.movielens import synthetic_ratings
    u, i, v = synthetic_ratings(U, I, n, rank=3, seed=seed)
    pl_ = sgd_mf.sorted_pass_layout(u, i, v, batch, axis='user',
                                    max_window=W)
    ql_ = sgd_mf.sorted_pass_layout(u, i, v, batch, axis='item',
                                    max_window=W)
    st = sgd_mf.init_state(U + pl_[-1], I + ql_[-1], 6, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(st.P, st.Q, st.bu, st.bi)
    return (tuple(jnp.asarray(x) for x in pl_[:-1]),
            tuple(jnp.asarray(x) for x in ql_[:-1]), pl_[-1], ql_[-1],
            Paug, Qaug, jnp.float32(v.mean()))


@pytest.mark.parametrize('link,bias_mode', [('identity', 'fixed'),
                                            ('logistic', 'learned')])
def test_alternating_epoch_kernel_path_matches_xla(monkeypatch, link,
                                                   bias_mode):
    '''make_alternating_epoch with the kernel selected (as on a GPU,
    kernel forced to interpret mode here) trains like the XLA path.'''
    pl, ql, Wu, Wi, Paug, Qaug, mu = _tiny_layouts()
    kw = dict(lr=0.15, K=0.02, lr_bu=0.05, lr_bi=0.05, bias_mode=bias_mode,
              link=link, clamp_pred=link == 'identity', chunk=128,
              inner_steps=3, donate=False)

    def run():
        sgd_mf.make_alternating_epoch.cache_clear()
        ep = sgd_mf.make_alternating_epoch(Wu, Wi, **kw)
        return ep(Paug, Qaug, mu, pl, ql)

    P_x, Q_x, r_x = run()
    real = pallas_half_pass.half_pass
    monkeypatch.setattr(sgd_mf, 'half_pass_kernel_default', lambda: True)
    monkeypatch.setattr(pallas_half_pass, 'half_pass',
                        lambda *a, **k: real(*a, **dict(k, interpret=True)))
    P_k, Q_k, r_k = run()
    sgd_mf.make_alternating_epoch.cache_clear()
    assert abs(float(r_k) - float(r_x)) < 1e-4
    # bf16-rounded XLA aggregation vs the kernel's f32 sums
    np.testing.assert_allclose(np.asarray(P_k), np.asarray(P_x), atol=5e-3)
    np.testing.assert_allclose(np.asarray(Q_k), np.asarray(Q_x), atol=5e-3)


@pytest.mark.parametrize('bias_mode', ['fixed', 'learned'])
def test_sharded_half_pass_kernel_under_shard_map(bias_mode):
    '''The kernel inside shard_map (interpret mode, 8-device CPU mesh)
    matches the sharded XLA half-pass.'''
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS
    from mfrec_tpu.data.movielens import synthetic_ratings
    from mfrec_tpu.parallel import alternating_sharded as alt
    from mfrec_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-device virtual mesh')
    D, U, I, k = 8, 160, 120, 6
    u, i, v = synthetic_ratings(U, I, 4000, rank=4, seed=9)
    p_layout, _, (Ushard, Ishard, W) = alt.build_sharded_alternating_layout(
        u, i, v, D, U, I, batch_size=256, max_window=32)
    st = sgd_mf.init_state(U, I, k, feature_init=0.1, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(np.asarray(st.P), np.asarray(st.Q),
                                        np.asarray(st.bu), np.asarray(st.bi))
    Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
    Q_full = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
    lrv, regv = sgd_mf.col_vectors(k, True, 0.2, 0.02, 0.05, 0.01,
                                   learned=bias_mode == 'learned')
    mesh = make_mesh(D)

    def run(kernel):
        def dev(Pl, Qf, kl, og, rb, mb, lo):
            lay = tuple(x.reshape(x.shape[1:]) for x in (kl, og, rb, mb, lo))
            P, sse = alt.sharded_half_pass(
                Pl, Qf, jnp.float32(v.mean()), lay, lrv, regv, W=W,
                chunk=256, inner_steps=2, kernel=kernel, interpret=kernel)
            return P, sse[None]
        f = shard_map(dev, mesh=mesh,
                      in_specs=(PS('dp'), PS()) + (PS('dp'),) * 5,
                      out_specs=(PS('dp'), PS('dp')), check_vma=False)
        P, sse = jax.jit(f)(Paug, Q_full,
                            *(jnp.asarray(x) for x in p_layout))
        return np.asarray(P), float(np.asarray(sse).sum())

    P_x, s_x = run(False)
    P_k, s_k = run(True)
    np.testing.assert_allclose(s_k, s_x, rtol=1e-5)
    np.testing.assert_allclose(P_k, P_x, atol=5e-3)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_twin():
    '''The compiled kernel (no interpret mode) against the twin; on a GPU
    only — chip_smoke.py runs the same compare at the real widths.'''
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU (compiled Triton kernel)')
    F_upd, F_fix, lay, W = _layout(64, seed=11)
    lrv, regv = _cols(64, 'fixed')
    kw = _kw('identity', 'fixed', 4)
    got, _ = pallas_half_pass.half_pass(
        jnp.asarray(F_upd), jnp.asarray(F_fix), *_dev(lay), lrv, regv, 3.5,
        W=W, **kw)
    want, _ = _twin(F_upd, F_fix, lay, W, lrv, regv, kw)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
