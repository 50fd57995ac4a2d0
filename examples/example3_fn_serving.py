'''
Example 3 — factorized-neighborhood model + production serving paths.

Demonstrates the round-2 surface on a MovieLens-100K-shaped dataset:
  * FNRecommender (Koren KDD'08 factored item-item model): train,
    held-out RMSE vs the bias-only floor, zero-retrain user fold-in;
  * batched top-N serving (`recommend_batch`) — auto-sharded over all
    visible devices, rated items masked on device;
  * a hyperparameter sweep that re-scores one trained model.

Runs anywhere (CPU included); uses the synthetic MovieLens-shaped
generator since the image has no network access.
'''
import os as _os
import sys as _sys
# runnable as `python examples/example3_fn_serving.py` from the repo
# root (sys.path[0] is examples/)
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import logging

import numpy as np

from mfrec_tpu.data.movielens import synthetic_ratings, train_test_split
from mfrec_tpu.eval.metrics import test_predict_rating
from mfrec_tpu.eval.sweep import optimize_k
from mfrec_tpu.models.fn import FNRecommender
from mfrec_tpu.models.knn_svd import KNNSVDRecommender

logging.basicConfig(level=logging.INFO)


def main():
    users, items, values = synthetic_ratings(
        nbr_users=943, nbr_items=1682, nbr_ratings=100_000, rank=8, seed=7)
    (u, i, v), test = train_test_split(users, items, values,
                                       test_fraction=0.2, seed=8)
    U, I = int(users.max()) + 1, int(items.max()) + 1

    model = FNRecommender(U, I, {
        'nbr_epochs': 60, 'nbr_features': 16,
        'learning_rate': 0.005, 'learning_rate_users': 0.005,
        'learning_rate_items': 0.005,
        'regularization_items': 0.02, 'regularization_users': 0.02,
        'feature_init': 0.05, 'batch_size': 2048,
    })
    model.seed(0)
    model.set_ratings(u, i, v)
    model.train(verbose=False)

    rmse = test_predict_rating(model, test, nbr_samples=len(test),
                               predictor='predict', quiet=True)[0]
    mu = float(v.mean())
    tu, ti = test[:, 0].astype(int), test[:, 1].astype(int)
    floor = float(np.sqrt(((test[:, 2] - np.clip(
        mu + model.users_bias[tu] + model.items_bias[ti], 1, 5)) ** 2)
        .mean()))
    print('FN held-out RMSE: %.4f (bias-only floor %.4f)' % (rmse, floor))

    # zero-retrain fold-in: the neighborhood model rebuilds the profile
    new_id = model.add_user('fresh-user', [1, 2, 3, 10], [5, 4, 5, 4])
    ids, scores = model.find_recommended_items(user_index=new_id,
                                               nbr_recommendations=5)
    print('cold-start recommendations:', ids)

    # batched serving — sharded over all visible devices automatically
    batch_ids, batch_scores = model.recommend_batch(
        list(range(16)), nbr_recommendations=10,
        predictor='predict_rating_with_bias')
    print('served batch of 16 users, top-10 shape:', batch_ids.shape)

    # sweep k on a trained kNN model without retraining
    knn = KNNSVDRecommender(U, I, {'nbr_features': 16, 'k': 20})
    knn.set_ratings(u, i, v)
    knn.train()
    ks, scores = optimize_k(knn, test, ks=[10, 20, 40, 80],
                            nbr_samples=2000)
    print('k sweep:', dict(zip(ks.tolist(), np.round(scores, 4).tolist())))


if __name__ == '__main__':
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
