'''
End-to-end WRMF on MovieLens-100K — mirror of the reference driver
(``mfrec/examples/example1b_movielens_100k_wrmf.py``), in JAX.

Loads `~/datasets/ml-100k/u1.base` if present; otherwise falls back to a
synthetic MovieLens-shaped dataset (the sandbox has no network access).

Run:  python examples/example1b_movielens_100k_wrmf.py
'''
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import logging
import os
import time

import numpy as np

from mfrec_tpu.eval.metrics import test_predict_rating, precision_recall
from mfrec_tpu.models.wrmf import WRMFRecommender
from mfrec_tpu.graph.similarity_graph import SimilarityGraph
from mfrec_tpu.data.movielens import load_ratings_file
from mfrec_tpu.data import ml100k_like

logging.basicConfig(level=logging.INFO)

# Acceptance floors at this operating point (30 epochs / 20 features /
# reg 0.015, the reference driver's hyperparameters).  Pinned on the
# ML-100K-faithful generator (exact published rating histogram, >=20
# ratings/user, Zipf items — see mfrec_tpu/data/ml100k_like.py) and
# asserted in CI (tests/test_acceptance_ml100k.py).
P5_FLOOR = 0.30
P10_FLOOR = 0.22


def load_dataset(dataset='u1'):
    home = os.getenv('HOME', '.')
    base = os.path.join(home, 'datasets/ml-100k', dataset + '.base')
    test = os.path.join(home, 'datasets/ml-100k', dataset + '.test')
    if os.path.exists(base):
        bu, bi, bv = load_ratings_file(base)
        tu, ti, tv = load_ratings_file(test)
        u_test = np.stack([tu, ti, tv], axis=1).astype(np.float64)
        return (bu, bi, bv), u_test, os.path.join(home,
                                                  'datasets/ml-100k/u.item')
    print('ml-100k not found locally — using the ML-100K-faithful '
          'synthetic u1 split (exact published marginals)')
    train, u_test = ml100k_like.u1_split(seed=0)
    return train, u_test.astype(np.float64), None


if __name__ == '__main__':
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    (users, items, values), u_test, item_file = load_dataset('u1')
    nbr_user = int(users.max())
    nbr_feature = int(items.max())

    parameters = {'nbr_epochs': 30,
                  'feature_init': 0.1,
                  'regularization_model': 0.015,
                  'nbr_features': 20,
                  'neighborhood': 1500}

    MovieLensRecommender = WRMFRecommender(nbr_user + 1, nbr_feature + 1,
                                           parameters)
    # implicit feedback: every interaction becomes preference 1.0
    MovieLensRecommender.set_ratings(users, items, np.ones_like(values))

    # attach movie-title labels if available
    if item_file and os.path.exists(item_file):
        import codecs
        for line in codecs.open(item_file, 'r', 'latin-1'):
            movie_id, title = line.split('|')[0:2]
            try:
                MovieLensRecommender.set_item_label(int(movie_id), title)
            except KeyError:
                pass

    t0 = time.time()
    MovieLensRecommender.train(verbose=True)
    print('train time: %.2fs' % (time.time() - t0))

    p5 = precision_recall(MovieLensRecommender, u_test,
                          nbr_recommendations=5, verbose=True)[0]
    p10 = precision_recall(MovieLensRecommender, u_test,
                           nbr_recommendations=10, verbose=True)[0]
    print('acceptance: P@5 %.4f (floor %.2f) %s | P@10 %.4f (floor %.2f) %s'
          % (p5, P5_FLOOR, 'PASS' if p5 >= P5_FLOOR else 'FAIL',
             p10, P10_FLOOR, 'PASS' if p10 >= P10_FLOOR else 'FAIL'))

    # similar items for an arbitrary title
    some_item = MovieLensRecommender.items_label[50]
    similars = MovieLensRecommender.similar_items_by_label(some_item, 10,
                                                           method='cosine')
    print('------------')
    print('items similar to %r:' % some_item)
    print(similars)

    # build + export the similarity graph
    sg = SimilarityGraph(MovieLensRecommender)
    sg.build_graph(min_score=0.95)
    sg.write_graph('/tmp/similarity_graph.graphml')
    print('graph written to /tmp/similarity_graph.graphml')
