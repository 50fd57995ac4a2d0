'''Factor-init symmetry breaking for jointly-trained engines.

The reference's constant ``np.full(feature_init)`` init
(gradient_descent.py:523-525) is a fixed point of the column-permutation
symmetry under JOINT training: every factor column receives the
identical gradient forever, so the model trains as rank 1 regardless of
``nbr_features``.  The reference never hits this because its Funk loop
is feature-SEQUENTIAL (features differentiate against the residual of
earlier ones).  Found end to end at the ML-10M bench shape (train RMSE
stalls at 0.692, a hair under the 0.703 bias floor, vs 0.29 ops-level
with random init).

``GDRecommender.init_mode``: 'auto' (default) = N(0, feature_init) for
joint engines, reference-exact constant for the sequential funk tiers;
'normal'/'constant' force either.
'''
import numpy as np
import pytest

from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.models.base import Error


def _planted(U=60, I=40, N=1500, rank=3, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, U, N).astype(np.int32)
    items = rng.integers(0, I, N).astype(np.int32)
    P = rng.normal(0, 1.0, (U, rank))
    Q = rng.normal(0, 1.0, (I, rank))
    raw = np.einsum('nk,nk->n', P[users], Q[items]) / np.sqrt(rank)
    vals = np.clip(3.0 + 1.2 * raw, 1.0, 5.0).astype(np.float32)
    return users, items, vals


def _model(extra=None, U=60, I=40):
    params = {'nbr_features': 6, 'feature_init': 0.1, 'min_epochs': 3,
              'max_epochs': 12, 'min_improvement': 1e-4,
              'regularization_model': 0.02, 'batch_size': 256,
              'inner_steps': 4, 'engine': 'alternating'}
    params.update(extra or {})
    return GDRecommender(U, I, params)


def test_joint_engine_auto_init_is_random():
    m = _model()
    m._init_factors(True)
    # columns must differ — a constant fill keeps them identical forever
    assert np.ptp(m.P) > 0 and np.ptp(m.Q) > 0
    assert not np.allclose(m.P[:, 0], m.P[:, 1])


def test_sequential_engine_keeps_reference_constant_init():
    m = _model({'engine': 'funk'})
    m._init_factors(True)
    assert np.all(m.P == np.float32(0.1)) and np.all(m.Q == np.float32(0.1))
    # hardwired-funk entry points keep it too, whatever self.engine says
    m2 = _model()          # engine='alternating'
    m2._init_factors(True, sequential=True)
    assert np.all(m2.P == np.float32(0.1))


def test_init_mode_forced_constant_and_validation():
    m = _model({'init_mode': 'constant'})
    m._init_factors(True)
    assert np.all(m.P == np.float32(0.1))
    bad = _model({'init_mode': 'bogus'})
    with pytest.raises(Error):
        bad._init_factors(True)


def test_init_is_deterministic_per_seed():
    a, b = _model(), _model()
    a._init_factors(True)
    b._init_factors(True)
    assert np.array_equal(a.P, b.P) and np.array_equal(a.Q, b.Q)
    c = _model()
    c.seed(7)
    c._init_factors(True)
    assert not np.array_equal(a.P, c.P)


def test_warm_start_untouched():
    m = _model()
    m._init_factors(True)
    P0 = m.P.copy()
    m._init_factors(False)      # warm start: no re-draw
    assert np.array_equal(m.P, P0)


def test_constant_init_collapses_joint_training_to_rank1():
    '''The defect itself: on planted rank-3 data, constant init leaves
    the columns identical through training (rank-1 model) and random
    init trains strictly better.'''
    users, items, vals = _planted()
    m_const = _model({'init_mode': 'constant'})
    m_const.set_ratings(users, items, vals)
    m_const.train(handle_bias=True)
    # every factor column identical after training: rank 1
    assert np.allclose(m_const.P, m_const.P[:, :1], atol=1e-6)
    assert np.allclose(m_const.Q, m_const.Q[:, :1], atol=1e-6)

    m_rand = _model()
    m_rand.set_ratings(users, items, vals)
    m_rand.train(handle_bias=True)
    assert not np.allclose(m_rand.P, m_rand.P[:, :1], atol=1e-4)
    assert m_rand.rmse_history[-1] < m_const.rmse_history[-1] - 0.005
