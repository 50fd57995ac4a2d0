'''
Train a model and serve it over HTTP (mfrec_tpu.serving).

The server fronts the batched device retrieval path: concurrent
/recommend requests are coalesced into one recommend_batch call
(blocked P@Q^T + fused top-k, mesh-sharded when >1 device).  This script trains on synthetic MovieLens-shaped data, starts
the server on an ephemeral port, issues a few requests against itself,
and exits — swap the last block for ``serve(model, port=8080)`` to run
a real endpoint.

Usage:  python examples/example5_serving_http.py
'''
import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from mfrec_tpu.data.movielens import synthetic_ratings
    from mfrec_tpu.models.gd import GDRecommender
    from mfrec_tpu.serving import RecommenderServer

    users, items, vals = synthetic_ratings(500, 300, 20_000, rank=5, seed=1)
    model = GDRecommender(500, 300, {
        'nbr_features': 16, 'min_epochs': 15, 'max_epochs': 15,
        'engine': 'fused', 'learning_rate': 0.02, 'batch_size': 4096})
    model.set_ratings(users, items, vals)
    model.train(handle_bias=True)

    srv = RecommenderServer(model)
    port = srv.start()
    print('serving on 127.0.0.1:%d' % port)
    try:
        for path in ('/health', '/recommend?user=42&n=5',
                     '/similar_items?item=7&n=3', '/predict?user=42&item=7'):
            with urllib.request.urlopen(
                    'http://127.0.0.1:%d%s' % (port, path), timeout=30) as r:
                print(path, '->', json.dumps(json.loads(r.read())))
    finally:
        srv.stop()


if __name__ == '__main__':
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
