'''ALS kernel parity vs. the numpy oracle of als_implicit.pyx, plus
end-to-end WRMF quality.'''
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfrec_tpu.data.movielens import ratings_from_arrays, synthetic_ratings
from mfrec_tpu.ops import als as als_ops


def _bool_sparse(r):
    '''Reference datasets.py:13-32 format: ([0, count...], col indices).'''
    u, i, _ = r.coo()
    rows_u = np.r_[0, np.bincount(u, minlength=r.nbr_users)].astype(np.int32)
    order = np.argsort(i, kind='stable')
    rows_i = np.r_[0, np.bincount(i, minlength=r.nbr_items)].astype(np.int32)
    return rows_u, i.astype(np.int32), rows_i, u[order].astype(np.int32)


def test_als_half_sweep_matches_oracle():
    '''One full epoch must reproduce the reference math exactly (f32 noise
    aside).  Longer horizons are compared by objective, not factors: the
    ALS fixed-point iteration is chaotic on binarized data, so trajectories
    diverge from 1e-8 perturbations after a few epochs.'''
    users, items, vals = synthetic_ratings(40, 25, 350, seed=5)
    r = ratings_from_arrays(users, items, np.ones_like(vals), 40, 25)
    dim, f_init, c_pos, reg = 6, 0.1, 1, 0.015

    uo = np.full((dim, 25), f_init)      # item factors [dim, items]
    vo = np.full((dim, 40), f_init)      # user factors [dim, users]
    ru, cu, ri, ci = _bool_sparse(r)
    als_ops.als_wrmf_oracle(1, dim, uo, vo, ru, cu, ri, ci, 40, 25,
                            c_pos=c_pos, k=reg)

    P = jnp.full((40, dim), f_init, jnp.float32)
    Q = jnp.full((25, dim), f_init, jnp.float32)
    ub = r.padded_rows(axis='user')
    ib = r.padded_rows(axis='item')
    P, Q = als_ops.als_wrmf_train(P, Q, ub, ib, nbr_epochs=1, c_pos=c_pos,
                                  reg=reg)
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    # zero-nnz rows: the oracle zeroes them, padded buckets skip them
    P[r.user_counts() == 0] = 0.0
    Q[r.item_counts() == 0] = 0.0
    vo[:, r.user_counts() == 0] = 0.0
    uo[:, r.item_counts() == 0] = 0.0
    np.testing.assert_allclose(P.T, vo, atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(Q.T, uo, atol=5e-3, rtol=1e-2)


def _wrmf_objective(P, Q, dense_bool, c_pos, reg):
    '''Confidence-weighted WRMF loss: sum c_ui (pref - P.Q)^2 + reg*norms.'''
    pred = P @ Q.T
    pref = dense_bool.astype(np.float64)
    conf = 1.0 + c_pos * pref
    return float((conf * (pref - pred) ** 2).sum()
                 + reg * ((P ** 2).sum() + (Q ** 2).sum()))


def test_als_multi_epoch_objective_parity():
    users, items, vals = synthetic_ratings(40, 25, 350, seed=5)
    r = ratings_from_arrays(users, items, np.ones_like(vals), 40, 25)
    dim, f_init, c_pos, reg = 6, 0.1, 1, 0.015
    dense = r.to_dense() != 0

    uo = np.full((dim, 25), f_init)
    vo = np.full((dim, 40), f_init)
    ru, cu, ri, ci = _bool_sparse(r)
    als_ops.als_wrmf_oracle(5, dim, uo, vo, ru, cu, ri, ci, 40, 25,
                            c_pos=c_pos, k=reg)
    loss_oracle = _wrmf_objective(vo.T, uo.T, dense, c_pos, reg)

    P = jnp.full((40, dim), f_init, jnp.float32)
    Q = jnp.full((25, dim), f_init, jnp.float32)
    P, Q = als_ops.als_wrmf_train(P, Q, r.padded_rows(axis='user'),
                                  r.padded_rows(axis='item'),
                                  nbr_epochs=5, c_pos=c_pos, reg=reg)
    loss_jax = _wrmf_objective(np.asarray(P, np.float64),
                               np.asarray(Q, np.float64), dense, c_pos, reg)
    assert loss_jax < loss_oracle * 1.05


def test_als_rating_scaled_confidence_changes_solution():
    users, items, vals = synthetic_ratings(30, 20, 250, seed=6)
    r = ratings_from_arrays(users, items, vals, 30, 20)
    ub = r.padded_rows(axis='user')
    ib = r.padded_rows(axis='item')
    P0 = jnp.full((30, 4), 0.1, jnp.float32)
    Q0 = jnp.full((20, 4), 0.1, jnp.float32)
    P1, Q1 = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=1, c_pos=1.0)
    P2, Q2 = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=1, alpha=2.0)
    assert not np.allclose(np.asarray(P1), np.asarray(P2))


def test_wrmf_model_end_to_end(small_dataset):
    from mfrec_tpu.models.wrmf import WRMFRecommender
    from mfrec_tpu.eval.metrics import precision_recall
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    model = WRMFRecommender(U, I, {'nbr_epochs': 10, 'nbr_features': 8,
                                   'regularization_model': 0.015})
    model.set_ratings(u, i, np.ones_like(v))     # implicit: 1.0 like example1b
    model.train()
    p, rec, f1 = precision_recall(model, test, nbr_recommendations=10)
    # planted-structure data: must beat random (~10/200 items = 0.05)
    assert p > 0.05
    # predictions come out of the factor dot product
    score = model.predict(int(i[0]), int(u[0]))
    assert np.isfinite(score)


def test_bf16_gram_accuracy(small_dataset):
    '''bf16 Gram corrections (the fast path) must track the f32
    solves closely: the k x k solve and accumulation stay f32, only the
    rank-L correction inputs are rounded.'''
    import jax.numpy as jnp
    from mfrec_tpu.data.movielens import ratings_from_arrays
    from mfrec_tpu.ops import als as als_ops
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    r = ratings_from_arrays(u, i, np.ones_like(v), U, I)
    ub = r.padded_rows(axis='user')
    ib = r.padded_rows(axis='item')
    rng = np.random.default_rng(0)
    P0 = jnp.asarray(rng.normal(0, 0.1, (U, 8)), jnp.float32)
    Q0 = jnp.asarray(rng.normal(0, 0.1, (I, 8)), jnp.float32)
    P32, Q32 = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=3)
    P16, Q16 = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=3,
                                      gram_dtype=jnp.bfloat16)
    # prediction-space agreement
    d = np.asarray(P32 @ Q32.T) - np.asarray(P16 @ Q16.T)
    rms = float(np.sqrt((d ** 2).mean()))
    assert rms < 2e-2, rms


def test_cg_solver_matches_exact(small_dataset):
    '''Warm-started matrix-free CG (the fast solver) reaches the
    exact batched-Cholesky fixed point (Takacs-style ALS-CG).'''
    import jax.numpy as jnp
    from mfrec_tpu.data.movielens import ratings_from_arrays
    from mfrec_tpu.ops import als as als_ops
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    r = ratings_from_arrays(u, i, np.ones_like(v), U, I)
    ub, ib = r.padded_rows(axis='user'), r.padded_rows(axis='item')
    rng = np.random.default_rng(0)
    P0 = jnp.asarray(rng.normal(0, 0.1, (U, 8)), jnp.float32)
    Q0 = jnp.asarray(rng.normal(0, 0.1, (I, 8)), jnp.float32)
    Pe, Qe = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=10)
    Pc, Qc = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=10,
                                    solver='cg', cg_steps=5)
    d = np.asarray(Pe @ Qe.T) - np.asarray(Pc @ Qc.T)
    # the CG tier assembles its Gram AND rhs from a bf16 gather of the
    # fixed side (one cast per half-sweep); prediction-space agreement
    # with the all-f32 exact solver carries that rounding (~1.6e-3 here),
    # well inside the 2e-2 accepted for the bf16 Gram corrections alone
    assert float(np.sqrt((d ** 2).mean())) < 3e-3


def test_wrmf_model_cg_solver(small_dataset):
    '''Model-level: solver='cg' via set_parameters trains and predicts.'''
    from mfrec_tpu.models.wrmf import WRMFRecommender
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = WRMFRecommender(U, I, {'nbr_epochs': 8, 'nbr_features': 8,
                               'solver': 'cg', 'cg_steps': 4,
                               'cg_warm_steps': 2, 'cg_warmup_epochs': 1})
    m.set_ratings(u, i, np.ones_like(v))
    m.train()
    assert np.isfinite(m.P).all() and np.isfinite(m.Q).all()
    assert np.abs(m.P).max() > 0


def test_cg_warm_schedule_matches_exact(small_dataset):
    '''Dropping to fewer CG steps after warm-up epochs (ops/als.py
    cg_warm_steps) stays at the exact fixed point: late epochs start
    from a nearly-converged x, so 2-3 iterations suffice.'''
    import jax.numpy as jnp
    from mfrec_tpu.data.movielens import ratings_from_arrays
    from mfrec_tpu.ops import als as als_ops
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    r = ratings_from_arrays(u, i, np.ones_like(v), U, I)
    ub, ib = r.padded_rows(axis='user'), r.padded_rows(axis='item')
    rng = np.random.default_rng(0)
    P0 = jnp.asarray(rng.normal(0, 0.1, (U, 8)), jnp.float32)
    Q0 = jnp.asarray(rng.normal(0, 0.1, (I, 8)), jnp.float32)
    Pe, Qe = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=10)
    Pw, Qw = als_ops.als_wrmf_train(P0, Q0, ub, ib, nbr_epochs=10,
                                    solver='cg', cg_steps=6,
                                    cg_warm_steps=3, cg_warmup_epochs=2)
    # fixed-point agreement in objective space (the quantity ALS
    # minimizes), not element space: truncated late-epoch CG wanders
    # within the same level set
    uu, ii, _ = r.coo()
    obs = np.zeros((U, I), bool)
    obs[uu, ii] = True
    C = np.where(obs, 2.0, 1.0)

    def obj(P, Q):
        S = np.asarray(P) @ np.asarray(Q).T
        return float((C * (obs - S) ** 2).sum()
                     + 0.015 * ((np.asarray(P) ** 2).sum()
                                + (np.asarray(Q) ** 2).sum()))

    oe, ow = obj(Pe, Qe), obj(Pw, Qw)
    assert abs(ow - oe) / oe < 2e-3, (oe, ow)


def test_wrmf_engine_sharded_matches_single_chip(small_dataset):
    '''The sharded ALS epoch must be reachable from
    the PUBLIC WRMF API and match the single-chip solve.  Exact solver:
    per-row normal equations are identical math, so factors agree to
    float tolerance after several epochs.'''
    import jax
    from mfrec_tpu.models.wrmf import WRMFRecommender
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1

    def run(engine, epochs, **extra):
        params = {'nbr_epochs': epochs, 'nbr_features': 8,
                  'engine': engine}
        params.update(extra)
        m = WRMFRecommender(U, I, params)
        m.set_ratings(u, i, np.ones_like(v))
        m.train()
        return m

    # 1 epoch: identical math, factor-level agreement (longer horizons
    # diverge element-wise — the ALS fixed-point iteration is chaotic on
    # binarized data; see test_als_half_sweep_matches_oracle note)
    single = run('als', 1)
    sharded = run('als_sharded', 1)
    np.testing.assert_allclose(sharded.P, single.P, atol=5e-3, rtol=5e-2)
    np.testing.assert_allclose(sharded.Q, single.Q, atol=5e-3, rtol=5e-2)
    # multi-epoch: same objective level set
    single6 = run('als', 6)
    sharded6 = run('als_sharded', 6)
    obs = np.zeros((U, I), bool)
    obs[u, i] = True
    C = np.where(obs, 2.0, 1.0)

    def obj(m):
        S = m.P @ m.Q.T
        return float((C * (obs - S) ** 2).sum()
                     + 0.025 * ((m.P ** 2).sum() + (m.Q ** 2).sum()))

    os_, oh = obj(single6), obj(sharded6)
    assert abs(os_ - oh) / os_ < 5e-3, (os_, oh)
    # 'auto' picks the sharded path on the 8-device virtual mesh
    assert len(jax.devices()) > 1
    auto = run('auto', 1)
    np.testing.assert_allclose(auto.P, sharded.P, atol=1e-5)


def test_wrmf_engine_sharded_cg(small_dataset):
    '''The warm-started Jacobi-PCG fast path also runs sharded from the
    public API.  Sharded CG must match single-chip CG near-exactly (same
    math over a different row partition); CG-vs-exact agreement is the
    bf16-Gram prediction-space tolerance (the CG tier always assembles
    its Gram in bf16, like the single-chip ``_bucket_cg_body``).'''
    from mfrec_tpu.models.wrmf import WRMFRecommender
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1

    def run(solver, engine):
        m = WRMFRecommender(U, I, {'nbr_epochs': 8, 'nbr_features': 8,
                                   'engine': engine, 'solver': solver,
                                   'cg_steps': 6, 'cg_warm_steps': 3,
                                   'cg_warmup_epochs': 2})
        m.set_ratings(u, i, np.ones_like(v))
        m.train()
        return m

    exact = run('exact', 'als_sharded')
    cg = run('cg', 'als_sharded')
    cg_single = run('cg', 'als')

    def pred_rms(a, b):
        d = a.P @ a.Q.T - b.P @ b.Q.T
        return float(np.sqrt((d ** 2).mean()))

    assert pred_rms(cg, cg_single) < 1e-3
    assert pred_rms(cg, exact) < 3e-2




@pytest.mark.parametrize('k', [8, 32])
def test_xla_pcg_matches_exact_solve(k):
    '''``pcg_solve`` (the only CG path) converges to the exact solution of
    batched SPD systems; a warm start near the answer stays there.'''
    from mfrec_tpu.ops.als import pcg_solve
    rng = np.random.default_rng(k)
    R = 64
    A = rng.normal(0, 1, (R, 3 * k, k))
    M = np.einsum('rlk,rlm->rkm', A, A) + 0.5 * np.eye(k)[None]
    b = rng.normal(0, 1, (R, k))
    x = np.linalg.solve(M, b[..., None])[..., 0]
    # reference products in full float32 (a GPU may otherwise use TF32)
    with jax.default_matmul_precision('highest'):
        got = np.asarray(pcg_solve(jnp.asarray(M, jnp.float32),
                                   jnp.asarray(b, jnp.float32),
                                   jnp.zeros((R, k), jnp.float32), 4 * k))
        warm = np.asarray(pcg_solve(jnp.asarray(M, jnp.float32),
                                    jnp.asarray(b, jnp.float32),
                                    jnp.asarray(x, jnp.float32), 3))
    np.testing.assert_allclose(got, x, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(warm, x, rtol=1e-3, atol=1e-4)
