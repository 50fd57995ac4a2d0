'''Cross-engine accuracy parity at ML-100K-like scale: the performance
engines (fused, alternating, dsgd) must reach held-out RMSE comparable to
each other and clearly better than the bias-only baseline — the empirical
parity protocol of BASELINE.md (the Py2 reference itself cannot run).'''
import numpy as np
import pytest

from mfrec_tpu.data.movielens import synthetic_ratings, train_test_split
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.eval import metrics as M
eval_predict_rating = M.test_predict_rating


@pytest.fixture(scope='module')
def ml100k_like():
    users, items, values = synthetic_ratings(
        nbr_users=943, nbr_items=1682, nbr_ratings=100_000, rank=10, seed=7)
    return train_test_split(users, items, values, 0.2, seed=8)


def _rmse(model, test):
    return eval_predict_rating(model, test, nbr_samples=5000,
                               predictor='predict_rating_with_bias',
                               quiet=True)[0]


def _bias_baseline_rmse(train, test):
    u, i, v = train
    mu = v.mean()
    bi = np.zeros(int(i.max()) + 1)
    bu = np.zeros(int(u.max()) + 1)
    cnt_i = np.bincount(i, minlength=bi.shape[0])
    bi = np.where(cnt_i > 0,
                  np.bincount(i, weights=v - mu, minlength=bi.shape[0])
                  / np.maximum(cnt_i, 1), 0.0)
    resid = v - mu - bi[i]
    cnt_u = np.bincount(u, minlength=bu.shape[0])
    bu = np.where(cnt_u > 0,
                  np.bincount(u, weights=resid, minlength=bu.shape[0])
                  / np.maximum(cnt_u, 1), 0.0)
    rows = test[:5000]
    pred = mu + bi[rows[:, 1].astype(int)] + bu[rows[:, 0].astype(int)]
    return float(np.sqrt(((rows[:, 2] - pred) ** 2).mean()))


def test_engines_reach_comparable_test_rmse(ml100k_like):
    train, test = ml100k_like
    u, i, v = train
    U, I = int(u.max()) + 1, int(i.max()) + 1
    baseline = _bias_baseline_rmse(train, test)

    results = {}
    configs = {
        'fused': {'learning_rate': 0.01, 'min_epochs': 40, 'max_epochs': 40,
                  'batch_size': 8192},
        # pin the sweep count: the shipped default T=128 is 16x this
        # test's tuned work on CPU
        'alternating': {'learning_rate': 0.5, 'min_epochs': 80,
                        'max_epochs': 80, 'batch_size': 8192,
                        'inner_steps': 8},
        'alternating_sharded': {'learning_rate': 0.5, 'min_epochs': 80,
                                'max_epochs': 80, 'batch_size': 8192,
                                'inner_steps': 2},
    }
    for engine, extra in configs.items():
        params = {'nbr_features': 16, 'regularization_model': 0.02,
                  'engine': engine}
        params.update(extra)
        m = GDRecommender(U, I, params)
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train(handle_bias=True)
        results[engine] = _rmse(m, test)

    # every engine beats the bias-only baseline
    for engine, rmse in results.items():
        assert rmse < baseline, (engine, rmse, baseline)
    # engines agree with each other within a loose band
    vals = list(results.values())
    assert max(vals) - min(vals) < 0.08, results
