'''Pins for the round-2 fix sweep (review items):
K2/K3 split, optimize_k applying k, threshold sweep without retraining,
min_epochs=0, non-chunk-multiple batch sizes, neighborhood candidate cap,
O(log) Ratings.get, zero-rating-user padded lists.'''
import numpy as np
import jax.numpy as jnp
import pytest

from mfrec_tpu.data.movielens import ratings_from_arrays
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.ops import sgd_mf


def _model(u, i, v, **over):
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': 5, 'max_epochs': 5, 'nbr_features': 6,
              'learning_rate': 0.02, 'regularization_model': 0.02,
              'batch_size': 1024}
    params.update(over)
    m = GDRecommender(U, I, params)
    m.seed(0)
    m.set_ratings(u, i, v)
    return m


def test_k2_k3_split_changes_learned_biases(small_dataset):
    '''regularization_users_bias (K2) and regularization_items_bias (K3)
    must independently reach the kernel: varying only K3 changes the
    learned item biases but (to first order) not via the user-bias path.'''
    (u, i, v), _ = small_dataset
    outs = {}
    for K3 in (0.0, 0.5):
        m = _model(u, i, v, regularization_users_bias=0.01,
                   regularization_items_bias=K3)
        m.feature_training_bias()
        outs[K3] = (m.users_bias.copy(), m.items_bias.copy())
    # item biases shrink under heavy K3
    assert np.abs(outs[0.5][1]).sum() < np.abs(outs[0.0][1]).sum()
    # and the two runs genuinely differ
    assert not np.allclose(outs[0.0][1], outs[0.5][1])


def test_serial_epoch_k2_k3_differ(tiny_dataset):
    '''Serial tier with K_bu != K_bi produces different biases per side
    than the collapsed version.'''
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    uj = jnp.asarray(u, jnp.int32)
    ij = jnp.asarray(i, jnp.int32)
    rj = jnp.asarray(v, jnp.float32)
    P = jnp.full((U, 3), 0.1, jnp.float32)
    Q = jnp.full((I, 3), 0.1, jnp.float32)
    res = {}
    for K_bu, K_bi in ((0.01, 0.01), (0.01, 0.4)):
        bu = jnp.zeros(U, jnp.float32)
        bi = jnp.zeros(I, jnp.float32)
        pf, qf, bu, bi, _ = sgd_mf.serial_feature_epoch(
            P[:, 0], Q[:, 0], jnp.zeros(rj.shape, jnp.float32),
            uj, ij, rj, 0, 3, 0.1, 0.01, 0.02, jnp.float32(v.mean()),
            bu, bi, 0.01, 0.01, K_bu, K_bi, bias_mode='learned', P=P, Q=Q)
        res[(K_bu, K_bi)] = (np.asarray(bu), np.asarray(bi))
    same, split = res[(0.01, 0.01)], res[(0.01, 0.4)]
    assert not np.allclose(same[1], split[1])                 # bi differs
    # heavier item-bias regularization shrinks item biases
    assert np.abs(split[1]).sum() < np.abs(same[1]).sum()


def test_optimize_k_applies_k(small_dataset):
    '''optimize_k must reconfigure the model per k (r1: constant sweep).'''
    from mfrec_tpu.eval.sweep import optimize_k
    from mfrec_tpu.models.knn_svd import KNNSVDRecommender
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = KNNSVDRecommender(U, I, {'nbr_features': 6, 'k': 10})
    m.set_ratings(u, i, v)
    m.train()
    ks, scores = optimize_k(m, test, ks=[1, 3, 40], nbr_samples=300,
                            predictor='predict')
    # k=1 < k_min=2 is skipped explicitly (r2 verdict item 9): no NaN
    # point, no numpy empty-slice warning
    assert ks.tolist() == [3, 40]
    assert not np.allclose(scores[0], scores[1]), (
        'sweep returned identical scores for k=3 and k=40')
    assert m.k == 10          # restored


def test_threshold_sweep_trains_once(small_dataset):
    from mfrec_tpu.eval import sweep as sweep_mod
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    calls = []

    class Counting(GDRecommender):
        def train(self, *a, **kw):
            calls.append(1)
            GDRecommender.train(self, *a, **kw)

    def factory(params):
        p = {'min_epochs': 2, 'max_epochs': 2, 'nbr_features': 4,
             'learning_rate': 0.02, 'batch_size': 1024}
        p.update(params)
        m = Counting(U, I, p)
        m.seed(0)
        m.set_ratings(u, i, v)
        return m

    ts, scores = sweep_mod.optimize_similarity_threshold(
        factory, {}, test, thresholds=[0.1, 0.5, 0.9], nbr_samples=200)
    assert len(calls) == 1, 'threshold sweep must train exactly once'
    assert len(scores) == 3


def test_min_epochs_zero_converge_only(small_dataset):
    '''min_epochs=0 means converge-only (was UnboundLocalError).'''
    (u, i, v), _ = small_dataset
    for engine in ('fused', 'funk_fused'):
        m = _model(u, i, v, min_epochs=0, max_epochs=3, engine=engine,
                   nbr_features=3)
        m.train()                      # must not raise
        assert len(m.rmse_history) >= 0
    from mfrec_tpu.engine.trainer import ConvergenceDriver
    # min_improvement=0: converge-only mode keeps going while improving
    d = ConvergenceDriver(0, 5, 0.0)
    d.run(lambda s: (s, 1.9 - 0.2 * len(d.history)), 0)
    assert len(d.history) == 5


def test_alternating_any_batch_size(small_dataset):
    '''batch sizes that are not chunk multiples must work.'''
    (u, i, v), _ = small_dataset
    pl_ = sgd_mf.sorted_pass_layout(u, i, v, 1000, axis='user')
    ql_ = sgd_mf.sorted_pass_layout(u, i, v, 1000, axis='item')
    W_user, W_item = pl_[-1], ql_[-1]
    p_layout = tuple(jnp.asarray(x) for x in pl_[:-1])
    q_layout = tuple(jnp.asarray(x) for x in ql_[:-1])
    U, I = int(u.max()) + 1, int(i.max()) + 1
    st = sgd_mf.init_state(U + W_user, I + W_item, 6, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(st.P, st.Q, st.bu, st.bi)
    epoch = sgd_mf.make_alternating_epoch(W_user, W_item, lr=0.2, K=0.02,
                                          bias_mode='fixed', chunk=512,
                                          donate=False)   # 1000 % 512 != 0
    Paug, Qaug, rmse = epoch(Paug, Qaug, jnp.float32(v.mean()),
                             p_layout, q_layout)
    assert np.isfinite(float(rmse))


def test_neighborhood_candidate_cap(small_dataset):
    (u, i, v), _ = small_dataset
    m = _model(u, i, v)
    m.train(handle_bias=True)
    ids_all, _ = m.find_recommended_items(user_index=3,
                                          nbr_recommendations=5)
    ids_cap, _ = m.find_recommended_items(user_index=3,
                                          nbr_recommendations=5,
                                          neighborhood=20)
    assert len(ids_cap) <= 5
    # capped candidates come from a 20-item subset: overlap with the
    # full-catalog top-5 is not guaranteed, but ids must be valid and
    # unrated
    rated = set(np.nonzero(m.ratings.rated_mask_for_user(3))[0])
    assert not (set(ids_cap) & rated)


def test_ratings_get_binary_search(small_dataset):
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    r = ratings_from_arrays(u, i, v, U, I)
    for s in range(0, u.shape[0], 97):
        assert r.get(int(u[s]), int(i[s])) == pytest.approx(float(v[s]))
    # missing pair
    dense = r.to_dense()
    uu, ii = np.nonzero(dense == 0)
    assert r.get(int(uu[0]), int(ii[0])) == 0.0


def test_padded_lists_zero_rating_user():
    '''A trailing user with no ratings must not index out of bounds.'''
    from mfrec_tpu.ops.topk import pad_rated_lists
    u = np.array([0, 0, 1], np.int32)
    i = np.array([0, 2, 1], np.int32)
    v = np.ones(3, np.float32)
    r = ratings_from_arrays(u, i, v, 4, 3)       # users 2,3 unrated
    idx, mask = pad_rated_lists(r, [0, 2, 3])
    assert mask[1].sum() == 0 and mask[2].sum() == 0
    np.testing.assert_array_equal(np.sort(idx[0][mask[0] > 0]), [0, 2])
