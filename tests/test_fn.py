'''FNRecommender — the factorized item-item neighborhood model
(Koren KDD'08 §4) that the reference declares but never implements
(fn.py:75-96).  Parity protocol: the fused mini-batch kernel vs the
strictly-sequential numpy oracle at final-RMSE tolerance, plus a
convergence test that must beat the bias-only baseline.'''
import numpy as np
import jax.numpy as jnp

from mfrec_tpu.data.movielens import ratings_from_arrays
from mfrec_tpu.models.fn import FNRecommender
from mfrec_tpu.ops import fn as fn_ops
from mfrec_tpu.ops import sgd_mf
from mfrec_tpu.ops.reference_numpy import fn_train_oracle


def _rated_lists(u, i, v, U):
    ids = [np.zeros(0, np.int64)] * U
    vals = [np.zeros(0, np.float64)] * U
    order = np.argsort(u, kind='stable')
    uu, ii, vv = u[order], i[order], v[order]
    starts = np.searchsorted(uu, np.arange(U))
    ends = np.searchsorted(uu, np.arange(U) + 1)
    for x in range(U):
        ids[x] = ii[starts[x]:ends[x]].astype(np.int64)
        vals[x] = vv[starts[x]:ends[x]].astype(np.float64)
    return ids, vals


def test_fn_kernel_matches_oracle_rmse(tiny_dataset):
    '''Order-changing mini-batch kernel vs sequential oracle: final-RMSE
    tolerance (the documented parity definition for parallel tiers).'''
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    k, f_init, lr, K = 4, 0.05, 0.01, 0.02
    epochs = 8
    mu = float(v.mean())

    # oracle
    rng = np.random.default_rng(0)
    Qo = rng.normal(0, f_init, (I, k))
    Xo = rng.normal(0, f_init, (I, k))
    Yo = rng.normal(0, f_init, (I, k))
    buo = np.zeros(U)
    bio = np.zeros(I)
    ids, vals = _rated_lists(u, i, v, U)
    idx = np.stack([u, i], 1)
    rmse_o = fn_train_oracle(epochs, lr, 0.005, 0.005, K, 0.01, 0.01, mu,
                             Qo, Xo, Yo, buo, bio, idx,
                             v.astype(np.float64), ids, vals)

    # fused kernel, same init
    state = fn_ops.FNState(
        Q=jnp.asarray(Qo * 0 + rng.normal(0, 0, (I, k)), jnp.float32),
        X=jnp.asarray(Xo, jnp.float32), Y=jnp.asarray(Yo, jnp.float32),
        bu=jnp.zeros(U, jnp.float32), bi=jnp.zeros(I, jnp.float32),
        mu=jnp.float32(mu))
    # re-draw the SAME Q init the oracle started from (it was mutated)
    rng2 = np.random.default_rng(0)
    Q0 = rng2.normal(0, f_init, (I, k))
    X0 = rng2.normal(0, f_init, (I, k))
    Y0 = rng2.normal(0, f_init, (I, k))
    state = state._replace(Q=jnp.asarray(Q0, jnp.float32),
                           X=jnp.asarray(X0, jnp.float32),
                           Y=jnp.asarray(Y0, jnp.float32))
    r = ratings_from_arrays(u, i, v, U, I)
    fl, fv, fm = fn_ops.padded_user_lists(r)
    ub, ib, rb, mb = sgd_mf.batch_ratings(u, i, v, 256, seed=1)
    epoch = fn_ops.make_fn_epoch(lr, 0.005, 0.005, K, 0.01, 0.01,
                                 donate=False)
    args = tuple(jnp.asarray(x) for x in (ub, ib, rb, mb, fl, fv, fm))
    for _ in range(epochs):
        state, rmse = epoch(state, *args)
    assert abs(float(rmse) - rmse_o) < 0.08, (float(rmse), rmse_o)


def test_fn_beats_bias_baseline(small_dataset):
    '''The neighborhood term must explain residual structure: held-out
    RMSE beats the bias-only (mu + b_u + b_i) baseline.'''
    from mfrec_tpu.eval.metrics import test_predict_rating
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 40, 'nbr_features': 8,
                             'learning_rate': 0.02,
                             'learning_rate_users': 0.01,
                             'learning_rate_items': 0.01,
                             'regularization_items': 0.02,
                             'regularization_users': 0.02,
                             'feature_init': 0.05, 'batch_size': 1024,
                             # these rates are tuned for the per-sample
                             # fused tier; the alternating default is
                             # covered by its own test below
                             'engine': 'fused'})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    rmse_fn = test_predict_rating(m, test, nbr_samples=len(test),
                                  predictor='predict', quiet=True)[0]
    # bias-only baseline on the same split
    mu = float(v.mean())
    tu = test[:, 0].astype(int)
    ti = test[:, 1].astype(int)
    pred = np.clip(mu + m.users_bias[tu] + m.items_bias[ti], 1.0, 5.0)
    rmse_bias = float(np.sqrt(((test[:, 2] - pred) ** 2).mean()))
    assert rmse_fn < rmse_bias - 0.02, (rmse_fn, rmse_bias)
    # training itself converged
    hist = m.get_rmse_history()
    assert hist[-1] < hist[0]


def test_fn_profiles_match_predict(small_dataset):
    '''self.P holds a_u: batched MF-style prediction == scalar predict.'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 5, 'nbr_features': 6,
                             'learning_rate': 0.05, 'batch_size': 1024})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    want = m.predict(7, 3)
    got = float(np.clip(m.overall_bias + m.users_bias[3] + m.items_bias[7]
                        + m.P[3] @ m.Q[7], 1.0, 5.0))
    assert abs(want - got) < 1e-5
    # serving path works
    ids, scores = m.find_recommended_items(user_index=3,
                                           nbr_recommendations=5)
    assert len(ids) == 5
    rated = set(np.nonzero(m.ratings.rated_mask_for_user(3))[0])
    assert not (set(ids) & rated)


def test_fn_add_user_fold_in(small_dataset):
    '''New user's profile comes from the neighborhood aggregation with no
    gradient steps (Koren §4's operational advantage).'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 5, 'nbr_features': 6,
                             'learning_rate': 0.05, 'batch_size': 1024})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    new_id = m.add_user('fresh', [1, 2, 3], [5.0, 4.0, 5.0])
    assert new_id == U
    assert np.abs(m.P[new_id]).sum() > 0
    p = m.predict(4, new_id)
    assert np.isfinite(p) and 1.0 <= p <= 5.0


def test_fn_save_load_roundtrip(tmp_path, small_dataset):
    '''X/Y/profiles survive save_state/load_state; fold-in still works.'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 5, 'nbr_features': 6,
                             'learning_rate': 0.02, 'batch_size': 1024})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    path = str(tmp_path / 'fn_state')
    m.save_state(path)

    m2 = FNRecommender(U, I)
    m2.load_state(path)
    np.testing.assert_allclose(m2.X, m.X)
    np.testing.assert_allclose(m2.Y, m.Y)
    np.testing.assert_allclose(m2.P, m.P, atol=1e-6)
    assert m2.predict(3, 5) == m.predict(3, 5)
    # fold-in works on the restored model
    new_id = m2.add_user('fresh', [1, 2], [5.0, 4.0])
    assert np.isfinite(m2.predict(4, new_id))


def test_fn_alternating_beats_bias_baseline(small_dataset):
    '''The DEFAULT engine (sorted-window alternating) at
    default rates: held-out RMSE beats the bias-only baseline.'''
    from mfrec_tpu.eval.metrics import test_predict_rating
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 30, 'nbr_features': 8,
                             'regularization_items': 0.02,
                             'regularization_users': 0.02,
                             'feature_init': 0.05,
                             'min_improvement': 1e-5})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    rmse_fn = test_predict_rating(m, test, nbr_samples=len(test),
                                  predictor='predict', quiet=True)[0]
    mu = float(v.mean())
    tu = test[:, 0].astype(int)
    ti = test[:, 1].astype(int)
    pred = np.clip(mu + m.users_bias[tu] + m.items_bias[ti], 1.0, 5.0)
    rmse_bias = float(np.sqrt(((test[:, 2] - pred) ** 2).mean()))
    assert rmse_fn < rmse_bias - 0.02, (rmse_fn, rmse_bias)
    hist = m.get_rmse_history()
    assert hist[-1] < hist[0]


def test_fn_alternating_at_least_fused_quality(small_dataset):
    '''Order-changing tier parity, directional: the alternating engine
    (T sweeps at the row-mean default rate) must converge AT
    LEAST as deep as the fused tier at its tuned per-sample rates —
    measured CPU-side: 0.250 vs 0.441 after 40 epochs (it converges far
    deeper; an equality band would be the wrong shape of assertion).'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1

    def run(engine, **extra):
        params = {'nbr_epochs': 40, 'nbr_features': 8,
                  'regularization_items': 0.02,
                  'regularization_users': 0.02,
                  'feature_init': 0.05, 'min_improvement': 1e-6,
                  'engine': engine}
        params.update(extra)
        m = FNRecommender(U, I, params)
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train()
        return m.get_rmse_history()[-1]

    r_alt = run('alternating')
    # fused tier at its tuned per-sample rates
    r_fused = run('fused', learning_rate=0.02, learning_rate_users=0.01,
                  learning_rate_items=0.01, batch_size=1024)
    assert r_alt <= r_fused + 0.02, (r_alt, r_fused)


def test_fn_inner_steps_improve_per_epoch_quality(small_dataset):
    '''More inner sweeps must not hurt per-epoch convergence (the
    ladder's quality direction).'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    out = {}
    for T in (1, 8):
        m = FNRecommender(U, I, {'nbr_epochs': 6, 'nbr_features': 6,
                                 'feature_init': 0.05,
                                 'min_improvement': -1.0,
                                 'inner_steps': T})
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train()
        out[T] = m.get_rmse_history()[-1]
    assert out[8] <= out[1] + 1e-6, out


def test_fn_sharded_tracks_single_chip(small_dataset):
    '''The FN sharded engine (parallel.fn_sharded, 8-device virtual
    mesh) converges like the single-chip alternating tier on the same
    data — RMSE-tolerance parity, like every order-changing tier.'''
    import jax
    if len(jax.devices()) < 8:
        import pytest
        pytest.skip('needs the 8-device virtual mesh')
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1

    def run(engine):
        m = FNRecommender(U, I, {'nbr_epochs': 15, 'nbr_features': 6,
                                 'regularization_items': 0.02,
                                 'regularization_users': 0.02,
                                 'feature_init': 0.05,
                                 'min_improvement': -1.0,
                                 'inner_steps': 2, 'batch_size': 1024,
                                 'engine': engine})
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train()
        return m

    m1 = run('alternating')
    m8 = run('alternating_sharded')
    h1, h8 = m1.get_rmse_history(), m8.get_rmse_history()
    assert h8[-1] < h8[0] - 0.05                    # converges
    assert abs(h1[-1] - h8[-1]) < 0.05, (h1[-1], h8[-1])
    # profiles materialized; serving path works on the sharded model
    ids, _ = m8.find_recommended_items(user_index=3, nbr_recommendations=5)
    assert len(ids) == 5
