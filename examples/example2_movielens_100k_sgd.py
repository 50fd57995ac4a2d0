'''
Explicit-feedback SGD MF on MovieLens-100K — the reference's main workflow
(``GDRecommender.train(handle_bias=True)``), with held-out RMSE/MAE and a
top-N quality report.  Falls back to synthetic MovieLens-shaped data when
the real files are absent.

Run:  python examples/example2_movielens_100k_sgd.py [engine]
      engine in {fused, alternating, funk, funk_fused, dsgd};
      default fused.
'''
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import numpy as np

from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.eval.metrics import test_predict_rating, precision_recall
from examples.example1b_movielens_100k_wrmf import load_dataset

if __name__ == '__main__':
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    engine = sys.argv[1] if len(sys.argv) > 1 else 'fused'
    (users, items, values), u_test, _ = load_dataset('u1')
    nbr_users = int(users.max()) + 1
    nbr_items = int(items.max()) + 1

    parameters = {'min_epochs': 30,
                  'max_epochs': 120,
                  'min_improvement': 1e-4,
                  'feature_init': 0.1,
                  'learning_rate': 0.2 if engine == 'alternating' else 0.01,
                  'regularization_model': 0.02,
                  'nbr_features': 16,
                  'engine': engine}

    model = GDRecommender(nbr_users, nbr_items, parameters)
    model.seed(0)
    model.set_ratings(users, items, values)

    t0 = time.time()
    model.train(handle_bias=True)
    print('engine=%s trained %d epochs in %.2fs (final train rmse %.4f)'
          % (engine, len(model.rmse_history), time.time() - t0,
             model.rmse_history[-1]))

    rmse, _ = test_predict_rating(model, u_test, nbr_samples=len(u_test),
                                  predictor='predict_rating_with_bias')
    p, r, f1 = precision_recall(model, u_test, nbr_recommendations=10,
                                predictor='predict_rating_with_bias',
                                verbose=True)

    # cold-start fold-in demo
    new_items = np.arange(10, dtype=np.int32)
    new_ratings = np.full(10, 5.0, np.float32)
    new_id = model.add_user('new-user', new_items, new_ratings)
    ids, scores = model.find_recommended_items(
        user_index=new_id, nbr_recommendations=5,
        predictor='predict_rating_with_bias')
    print('cold-start recommendations for folded-in user:', ids)
