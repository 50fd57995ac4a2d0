'''Round-4 fixes (review findings):

* DefaultRate sentinel — a user who DIRECTLY assigns the reference
  default learning rate must train at that rate on the alternating
  engines, not at the silent row-mean substitute.
* Batched kNN vote paths (``_knn_user_votes``) — numerically equal to
  the per-item python vote loops they replace.
* ``pad_rated_lists``: the ``pad_to`` fixed-width serving contract wins
  over ``cap``.
* API-input guards raise (survive ``python -O``) instead of assert.
* Serving view rebuild failures retry instead of pinning readers to the
  stale view until the next write.
'''
import time

import numpy as np
import pytest

from mfrec_tpu.models.base import DefaultRate, Error
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.models.kmf import KMFRecommender


# ------------------------------------------------------- lr sentinel

def test_default_lr_substitutes_row_mean():
    m = GDRecommender(4, 4)
    assert isinstance(m.learning_rate, DefaultRate)
    assert float(m.learning_rate) == 0.001          # numerically the ref
    lr, lr_bu, lr_bi = m._alt_lrs()
    assert lr == lr_bu == lr_bi == 0.15


def test_direct_assignment_of_default_value_wins():
    '''m.learning_rate = 0.001 (the documented reference default) is a
    user choice and must NOT be silently overridden to 0.15
    (r3 verdict weak #4 — previously undetectable).'''
    m = GDRecommender(4, 4)
    m.learning_rate = 0.001
    assert m._alt_lrs()[0] == 0.001
    # bias rates still follow the resolved lr when unset
    assert m._alt_lrs() == (0.001, 0.001, 0.001)


def test_set_parameters_default_value_wins():
    m = GDRecommender(4, 4, {'learning_rate': 0.001})
    assert m._alt_lrs()[0] == 0.001


def test_partial_assignment_bias_rates():
    m = GDRecommender(4, 4)
    m.learning_rate_users = 0.07
    lr, lr_bu, lr_bi = m._alt_lrs()
    assert (lr, lr_bu, lr_bi) == (0.15, 0.07, 0.15)


def test_kmf_default_and_direct_assignment():
    m = KMFRecommender(4, 4)
    assert m._alt_lr() == 0.15
    m.learning_rate = 0.01                          # the kmf ref default
    assert m._alt_lr() == 0.01


def test_direct_assignment_trains_at_that_rate(tiny_dataset):
    '''End-to-end on the alternating engine: lr=0.001 by direct
    assignment barely moves row-mean steps, so its first-epoch RMSE
    stays far above the row-mean default's — proof the assigned rate
    (not 0.15) reached the kernel.'''
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1

    def train(assign):
        m = GDRecommender(U, I, {'min_epochs': 10, 'max_epochs': 10,
                                 'nbr_features': 6,
                                 'engine': 'alternating',
                                 'batch_size': 512, 'inner_steps': 4})
        if assign is not None:
            m.learning_rate = assign
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train(handle_bias=True)
        return m.get_rmse_history()

    slow = train(0.001)
    fast = train(None)
    drop_slow = slow[0] - slow[-1]
    drop_fast = fast[0] - fast[-1]
    assert drop_fast > 5 * drop_slow and drop_fast > 1e-3, (slow, fast)


# ------------------------------------------------- batched kNN votes

@pytest.fixture(scope='module')
def knn_model(tiny_dataset):
    from mfrec_tpu.models.knn_svd import KNNSVDRecommender
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = KNNSVDRecommender(U, I, {'nbr_features': 6, 'k': 10})
    m.set_ratings(u, i, v)
    m.train()
    return m


def _loop_top_match(m, user_index, k, k_min, sim, norm):
    '''The per-item python vote loop (reference base.py:899-927), kept
    here as the equality oracle.  Calls the BASE vote directly:
    KNNSVDRecommender's override swaps the (item, user) argument order
    (reference knn_svd.py:137), which made the reference's own
    find_user_top_match vote for the wrong (user, item) pairs when
    dispatching positionally (knn_svd.py:474) — a reference defect the
    batched path deliberately does not replicate.'''
    from mfrec_tpu.models.base import BaseRecommender
    scores = np.zeros(m.nbr_items)
    rated = m.ratings.rated_mask_for_user(user_index)
    for i in range(m.nbr_items):
        if rated[i] or i == user_index:
            continue
        try:
            scores[i] = BaseRecommender.predict_rating_userbased(
                m, user_index, i, k, k_min, 'All', sim, norm)
        except Error:
            scores[i] = 0.0
    nz = np.nonzero(scores)[0]
    order = nz[np.argsort(-scores[nz], kind='stable')]
    return [int(i) for i in order], [float(scores[i]) for i in order]


@pytest.mark.parametrize('norm', [True, False])
def test_find_user_top_match_matches_loop(knn_model, norm):
    m = knn_model
    for user in (0, 3, 17):
        ids_v, sc_v = m.find_user_top_match(user, k=8, k_min=2, sim=0.05,
                                            rating_normalisation=norm)
        ids_l, sc_l = _loop_top_match(m, user, k=8, k_min=2, sim=0.05,
                                      norm=norm)
        assert ids_v == ids_l, (user, ids_v[:5], ids_l[:5])
        np.testing.assert_allclose(sc_v, sc_l, rtol=1e-10, atol=1e-12)


def test_predict_batch_matches_predict(knn_model):
    m = knn_model
    rng = np.random.default_rng(0)
    items = rng.integers(0, m.nbr_items, 40)
    users = rng.integers(0, m.nbr_users, 40)
    batch = m.predict_batch(items, users)
    for j, (i, u) in enumerate(zip(items, users)):
        try:
            expect = m.predict(int(i), int(u))
        except Error:
            assert np.isnan(batch[j]), (j, batch[j])
            continue
        np.testing.assert_allclose(batch[j], expect, rtol=1e-10,
                                   atol=1e-12, err_msg=str((i, u)))


def test_find_user_top_match_items_scaling(tiny_dataset):
    '''Smoke: the batched vote stays one pass as items grow (no per-item
    python work) — just correctness at a larger item count here.'''
    from mfrec_tpu.models.knn_svd import KNNSVDRecommender
    rng = np.random.default_rng(5)
    U, I = 40, 400
    u = rng.integers(0, U, 3000).astype(np.int32)
    i = rng.integers(0, I, 3000).astype(np.int32)
    v = rng.integers(1, 6, 3000).astype(np.float32)
    m = KNNSVDRecommender(U, I, {'nbr_features': 6, 'k': 10})
    m.set_ratings(u, i, v)
    m.train()
    ids, scores = m.find_user_top_match(2, k=10, k_min=2, sim=0.01)
    assert len(ids) == len(scores) > 0
    assert all(np.isfinite(scores))
    # returned items unrated by the user
    rated = m.ratings.rated_mask_for_user(2)
    assert not any(rated[j] for j in ids)


# ---------------------------------------------- pad_to/cap contract

def test_pad_rated_lists_pad_to_wins_over_cap(tiny_dataset):
    from mfrec_tpu.ops.topk import pad_rated_lists
    from mfrec_tpu.data.movielens import ratings_from_arrays
    (u, i, v), _ = tiny_dataset
    r = ratings_from_arrays(u, i, v, int(u.max()) + 1, int(i.max()) + 1)
    idx, mask = pad_rated_lists(r, np.arange(8), pad_to=64, cap=16)
    assert idx.shape[1] == 64                # fixed serving width holds
    idx2, _ = pad_rated_lists(r, np.arange(8), cap=8)
    assert idx2.shape[1] <= 8                # cap alone still caps


# ------------------------------------------------ ValueError guards

# --------------------------------------------- serving refresh retry

def test_refresh_loop_retries_after_rebuild_failure(monkeypatch):
    from mfrec_tpu.data.movielens import synthetic_ratings
    from mfrec_tpu.serving import server as srv_mod
    users, items, vals = synthetic_ratings(30, 20, 400, rank=3, seed=7)
    m = GDRecommender(30, 20, {'nbr_features': 4, 'min_epochs': 2,
                               'max_epochs': 2, 'engine': 'fused',
                               'learning_rate': 0.02, 'batch_size': 256})
    m.set_ratings(users, items, vals)
    m.train(handle_bias=True)
    srv = srv_mod.RecommenderServer(m, view_refresh_ms=10.0, warmup=False)
    try:
        real_view = srv_mod._ServingView
        fails = {'n': 2}

        def flaky(model, *args, **kwargs):
            if fails['n'] > 0:
                fails['n'] -= 1
                raise RuntimeError('transient rebuild failure')
            return real_view(model, *args, **kwargs)

        monkeypatch.setattr(srv_mod, '_ServingView', flaky)
        old_view = srv.view
        srv._stale.set()                       # simulate a write
        deadline = time.monotonic() + 20.0
        while srv.view is old_view and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.view is not old_view, \
            'refresher never recovered from transient rebuild failures'
        assert fails['n'] == 0                 # it actually retried
    finally:
        srv.stop()


# ------------------------------------- r4 self-review closures (late r4)

def test_resilience_requires_alternating_engine(tiny_dataset):
    '''resilience>0 on an engine that does not wire ResilientDriver must
    refuse loudly, not silently train unprotected (r4 self-review #5).'''
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = GDRecommender(U, I, {'min_epochs': 2, 'max_epochs': 2,
                             'nbr_features': 4, 'engine': 'fused',
                             'resilience': 2})
    m.seed(0)
    m.set_ratings(u, i, v)
    with pytest.raises(Error, match='resilience'):
        m.train(handle_bias=True)


def test_resilience_ok_on_alternating(tiny_dataset):
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = GDRecommender(U, I, {'min_epochs': 2, 'max_epochs': 2,
                             'nbr_features': 4, 'engine': 'alternating',
                             'batch_size': 256, 'inner_steps': 2,
                             'resilience': 1})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)                     # must not raise
    assert np.isfinite(m.get_rmse_history()[-1])


