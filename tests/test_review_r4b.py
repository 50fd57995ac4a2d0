'''Late-round-4 whole-package review findings, each with its repro:

* sharded XLA top-N returned phantom padded item ids (>= nbr_items)
  under predictors whose score form ignores the item bias
  (dot/dot_plus_one) — pad rows scored dot+1 = 1.0 and outranked real
  items with negative dots.
* ``recommend_batch`` silently coerced mode-None predictors
  (SVDRecommender, KNNSVDRecommender) to 'dot_plus_one', ranking with
  the wrong score; it now routes through the model's own host
  predictor like ``find_recommended_items``.
* ``Ratings.set``/``set_many`` accepted out-of-range indices that
  reached the native counting sort as out-of-bounds writes; they now
  raise IndexError at write time (the reference's lil_matrix behavior).
* ``resilience_dir`` advertised crash resume but no resume path
  existed; ``ResilientDriver.run`` now loads a compatible snapshot.
* ``funk_train_oracle`` read ``rmse_last`` before assignment
  (NameError at min_epochs=0; stale value across features).
'''
import numpy as np
import pytest

import jax

from mfrec_tpu.models.gd import GDRecommender


# --------------------------------------- sharded pad rows never surface

def test_sharded_topn_no_phantom_pad_ids():
    '''6 items over 8 devices (2 all-pad shards), dot_plus_one predictor,
    all dots negative: every real item scores < 1.0 while a pad row
    would score exactly 1.0 — any id >= nbr_items with a live score is
    the phantom bug.'''
    from mfrec_tpu.parallel.topn_sharded import sharded_topn
    from mfrec_tpu.ops import topk as topk_ops
    U, I, k, n = 3, 6, 4, 4
    P = -np.ones((U, k), np.float32)
    Q = np.ones((I, k), np.float32) * np.linspace(
        0.1, 1.0, I, dtype=np.float32)[:, None]
    bu = np.zeros(U, np.float32)
    bi = np.zeros(I, np.float32)
    rated_idx = np.zeros((U, 1), np.int32)
    rated_mask = np.zeros((U, 1), np.float32)
    for predictor in ('dot_plus_one', 'dot', 'logistic'):
        idx, sc = sharded_topn(P, Q, bu, bi, 0.0, rated_idx, rated_mask,
                               n, predictor=predictor)
        live = np.asarray(sc) > topk_ops.NEG / 2
        assert np.all(np.asarray(idx)[live] < I), (predictor, idx, sc)
        # all real items are rankable, so the top-n must be full
        assert live.all(), (predictor, sc)


def test_sharded_topn_matches_single_chip_dot_plus_one():
    from mfrec_tpu.parallel.topn_sharded import sharded_topn
    from mfrec_tpu.ops import topk as topk_ops
    rng = np.random.default_rng(0)
    U, I, k, n = 5, 13, 4, 5          # 13 % 8 != 0 -> pad rows exist
    P = rng.normal(size=(U, k)).astype(np.float32) - 1.0
    Q = rng.normal(size=(I, k)).astype(np.float32) - 1.0
    bu = np.zeros(U, np.float32)
    bi = np.zeros(I, np.float32)
    rated_idx = np.zeros((U, 1), np.int32)
    rated_mask = np.zeros((U, 1), np.float32)
    idx_s, sc_s = sharded_topn(P, Q, bu, bi, 0.0, rated_idx, rated_mask,
                               n, predictor='dot_plus_one')
    idx_1, sc_1 = topk_ops.topn_scores(
        np.asarray(P), np.asarray(Q), np.asarray(bu), np.asarray(bi),
        0.0, rated_idx, rated_mask, n, predictor='dot_plus_one')
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_1))
    np.testing.assert_allclose(np.asarray(sc_s), np.asarray(sc_1),
                               rtol=1e-5, atol=1e-5)


# --------------------------- mode-None models host-score recommend_batch

def test_recommend_batch_svd_matches_host_predictor(tiny_dataset):
    from mfrec_tpu.models.svd import SVDRecommender
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = SVDRecommender(U, I, {'nbr_features': 6})
    m.set_ratings(u, i, v)
    m.train()
    users = [0, 3, 7]
    idx, sc = m.recommend_batch(users, nbr_recommendations=5)
    for row, uu in enumerate(users):
        want_ids, want_sc = m.find_recommended_items(
            user_index=uu, nbr_recommendations=5)
        got = list(idx[row][: len(want_ids)])
        assert got == list(want_ids), (uu, got, want_ids)
        np.testing.assert_allclose(sc[row][: len(want_sc)], want_sc,
                                   rtol=1e-5, atol=1e-5)


def test_recommend_batch_knn_svd_matches_host_predictor(tiny_dataset):
    from mfrec_tpu.models.knn_svd import KNNSVDRecommender
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = KNNSVDRecommender(U, I, {'nbr_features': 6, 'k': 5})
    m.set_ratings(u, i, v)
    m.train()
    users = [1, 4]
    idx, sc = m.recommend_batch(users, nbr_recommendations=4)
    for row, uu in enumerate(users):
        want_ids, _ = m.find_recommended_items(user_index=uu,
                                               nbr_recommendations=4)
        assert list(idx[row][: len(want_ids)]) == list(want_ids)


# ------------------------------------------------ ratings bounds checks

def test_ratings_set_out_of_range_raises():
    from mfrec_tpu.data.ratings import Ratings
    r = Ratings(4, 6)
    with pytest.raises(IndexError):
        r.set(0, 10, 4.0)
    with pytest.raises(IndexError):
        r.set(4, 0, 4.0)
    with pytest.raises(IndexError):
        r.set(-1, 0, 4.0)
    r.set(3, 5, 4.0)                              # in range still fine
    u, i, v = r.coo()
    assert u.tolist() == [3] and i.tolist() == [5]


def test_ratings_set_many_out_of_range_raises():
    from mfrec_tpu.data.ratings import Ratings
    r = Ratings(4, 6)
    with pytest.raises(IndexError):
        r.set_many([0, 1], [2, 6], [1.0, 2.0])
    with pytest.raises(IndexError):
        r.set_many([0, -2], [2, 3], [1.0, 2.0])
    r.set_many([0, 1], [2, 3], [1.0, 2.0])
    assert r.nnz == 2


def test_ratings_grow_then_set_in_new_range():
    from mfrec_tpu.data.ratings import Ratings
    r = Ratings(2, 2)
    r.grow(nbr_users=3, nbr_items=4)
    r.set(2, 3, 5.0)                               # fold-in pattern
    assert r.nnz == 1


# --------------------------------------------------------- crash resume

def _counting_factory(log):
    def factory(lr_scale):
        def epoch(state):
            s = int(state) + 1
            log.append(s)
            return np.asarray(s), 1.0 / s
        return epoch
    return factory


def test_resilient_driver_resumes_from_checkpoint(tmp_path):
    from mfrec_tpu.engine.trainer import ResilientDriver
    path = str(tmp_path / 'ckpt')
    log1 = []
    d1 = ResilientDriver(min_epochs=4, max_epochs=4, min_improvement=0.0,
                         snapshot_every=2, checkpoint_dir=path)
    out1 = d1.run(_counting_factory(log1), np.asarray(0))
    assert int(out1) == 4
    # a new driver (fresh process analog) resumes from epoch 4, not 0
    log2 = []
    d2 = ResilientDriver(min_epochs=6, max_epochs=6, min_improvement=0.0,
                         snapshot_every=2, checkpoint_dir=path)
    out2 = d2.run(_counting_factory(log2), np.asarray(0))
    assert int(out2) == 6
    assert log2 == [5, 6], log2                   # continued, not restarted
    assert len(d2.history) == 6


def test_resilient_driver_mismatched_checkpoint_trains_fresh(tmp_path):
    from mfrec_tpu.engine.trainer import ResilientDriver
    path = str(tmp_path / 'ckpt')
    d1 = ResilientDriver(min_epochs=2, max_epochs=2, min_improvement=0.0,
                         snapshot_every=1, checkpoint_dir=path)
    d1.run(_counting_factory([]), np.asarray(0))
    # different state shape: must NOT load the stale snapshot
    log = []

    def factory(lr_scale):
        def epoch(state):
            log.append(1)
            return state + 1.0, 1.0
        return epoch
    d2 = ResilientDriver(min_epochs=1, max_epochs=1, min_improvement=0.0,
                         snapshot_every=1, checkpoint_dir=path)
    out = d2.run(factory, np.zeros((3, 2), np.float32))
    assert out.shape == (3, 2) and len(log) == 1


def test_model_level_crash_resume(tiny_dataset, tmp_path):
    '''Kill-and-rerun analog: a second train() with the same
    resilience_dir continues from the snapshot instead of epoch 0.'''
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    path = str(tmp_path / 'resume')

    def make(max_epochs):
        m = GDRecommender(U, I, {'min_epochs': max_epochs,
                                 'max_epochs': max_epochs,
                                 'nbr_features': 4,
                                 'engine': 'alternating',
                                 'batch_size': 256, 'inner_steps': 2,
                                 'resilience': 1,
                                 'resilience_snapshot_every': 2,
                                 'resilience_dir': path})
        m.seed(0)
        m.set_ratings(u, i, v)
        return m
    m1 = make(4)
    m1.train(handle_bias=True)
    hist1 = list(m1.get_rmse_history())
    m2 = make(6)                                   # "restarted process"
    m2.train(handle_bias=True)
    hist2 = list(m2.get_rmse_history())
    # resumed: history carries the first run's snapshot prefix and the
    # resumed run only adds the remaining epochs
    assert len(hist2) == 6
    np.testing.assert_allclose(hist2[:4], hist1[:4], rtol=1e-6)


# ------------------------------------------------- funk oracle epoch rule

def test_funk_oracle_min_epochs_zero_no_crash():
    from mfrec_tpu.ops.reference_numpy import funk_train_oracle
    rng = np.random.default_rng(0)
    n, U, I, dim = 30, 5, 6, 3
    ridx = np.stack([rng.integers(0, I, n), rng.integers(0, U, n)],
                    1).astype(np.int64)          # [item, user] per oracle
    ratings = rng.uniform(1, 5, n)
    u = np.full((dim, I), 0.1)
    v = np.full((dim, U), 0.1)
    hist = funk_train_oracle(0, 5, 1e-3, dim, 0.1, 0.01, 0.02, u, v,
                             np.stack([ridx[:, 1], ridx[:, 0]], 1),
                             ratings)
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(v))
    assert isinstance(hist, list)


# ------------------------------------- second review pass (late r4)

def test_rollback_resets_best_no_spurious_exhaustion():
    '''Epochs improve to 0.3 then diverge BEFORE any snapshot: the
    rollback replays from init, whose healthy first RMSE (1.3) exceeds
    blowup_factor x the discarded trajectory's best (4 x 0.3) — with
    the stale best the driver spuriously exhausts max_retries.'''
    from mfrec_tpu.engine.trainer import ResilientDriver

    def factory(lr_scale):
        def epoch(state):
            step = int(state) + 1
            if lr_scale == 1.0:
                rmse = [0.5, 0.3, float('nan')][min(step - 1, 2)]
            else:                     # backed-off replay, converging
                rmse = 1.3 / step
            return np.asarray(step), rmse
        return epoch

    d = ResilientDriver(min_epochs=3, max_epochs=6, min_improvement=0.0,
                        snapshot_every=5, max_retries=1)
    out = d.run(factory, np.asarray(0))          # must not raise
    assert d.recoveries == 1
    assert np.isfinite(d.history[-1])


def test_coerce_state_rejects_dtype_mismatch(tmp_path):
    from mfrec_tpu.engine.trainer import ResilientDriver
    path = str(tmp_path / 'ckpt')
    d1 = ResilientDriver(min_epochs=2, max_epochs=2, min_improvement=0.0,
                         snapshot_every=1, checkpoint_dir=path)

    def f32_factory(lr_scale):
        def epoch(state):
            return state + np.float32(1.0), 1.0
        return epoch
    d1.run(f32_factory, np.zeros((2, 2), np.float32))
    log = []

    def f64_factory(lr_scale):
        def epoch(state):
            log.append(1)
            return state + 1.0, 1.0
        return epoch
    d2 = ResilientDriver(min_epochs=1, max_epochs=1, min_improvement=0.0,
                         snapshot_every=1, checkpoint_dir=path)
    out = d2.run(f64_factory, np.zeros((2, 2), np.float64))
    assert out.dtype == np.float64 and len(log) == 1   # trained fresh


def test_ranking_metrics_ignores_neg_filler():
    '''recommend_batch filler slots (id 0, score NEG) must not count as
    recommendations — phantom hits inflated NDCG/MRR/coverage whenever
    item 0 was relevant.'''
    from mfrec_tpu.eval.metrics import ranking_metrics
    from mfrec_tpu.ops.topk import NEG

    class Stub:
        nbr_users = 3
        nbr_items = 10

        def recommend_batch(self, users, nbr_recommendations,
                            predictor=None):
            B = len(users)
            ids = np.zeros((B, nbr_recommendations), np.int64)
            sc = np.full((B, nbr_recommendations), NEG, np.float32)
            ids[:, 0] = 5
            sc[:, 0] = 1.0                       # one real rec: item 5
            return ids, sc

    u_test = np.asarray([[0, 0, 5.0],            # item 0 relevant for u0
                         [1, 5, 5.0]])           # item 5 relevant for u1
    out = ranking_metrics(Stub(), u_test, nbr_recommendations=4)
    assert out['mrr'] == pytest.approx(0.5)      # u0 no hit, u1 rank 1
    assert out['coverage'] == pytest.approx(0.1)  # only item 5 recommended


def test_server_refresh_clears_stale(tiny_dataset):
    from mfrec_tpu.serving.server import RecommenderServer
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = GDRecommender(U, I, {'min_epochs': 2, 'max_epochs': 2,
                             'nbr_features': 4, 'engine': 'alternating',
                             'batch_size': 256, 'inner_steps': 2})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)
    srv = RecommenderServer(m, port=0, warmup=False,
                            view_refresh_ms=10_000.0)
    try:
        srv.rate(0, 1, 5.0) if hasattr(srv, 'rate') else srv._stale.set()
        srv.refresh(timeout=2.0)
        assert not srv._stale.is_set()
    finally:
        srv.stop()


def test_norm_cosine_is_component_mean_centered():
    '''ops-level norm_cosine must center by the component mean (it was
    byte-identical to cosine_log, a documented-but-unimplemented trap).'''
    from mfrec_tpu.ops.similarity import similar_topk
    rng = np.random.default_rng(3)
    F = rng.normal(size=(12, 5)).astype(np.float32) + 2.0  # offset mean
    q = np.asarray([2, 7])
    idx_n, sim_n = similar_topk(F, q, k=3, method='norm_cosine')
    Fc = F - F.mean(axis=0, keepdims=True)
    idx_c, sim_c = similar_topk(Fc, q, k=3, method='cosine_log')
    np.testing.assert_array_equal(np.asarray(idx_n), np.asarray(idx_c))
    np.testing.assert_allclose(np.asarray(sim_n), np.asarray(sim_c),
                               rtol=1e-5, atol=1e-6)
    # and it genuinely differs from the uncentered variant
    idx_u, sim_u = similar_topk(F, q, k=3, method='cosine_log')
    assert not np.allclose(np.asarray(sim_n), np.asarray(sim_u))


