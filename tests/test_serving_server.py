'''HTTP serving front (mfrec_tpu.serving): endpoints + micro-batching.'''
import json
import threading
import urllib.request

import numpy as np

from mfrec_tpu.data.movielens import synthetic_ratings
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.serving import RecommenderServer


def _get(port, path):
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d%s' % (port, path),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _make_model():
    users, items, vals = synthetic_ratings(80, 50, 1500, rank=3, seed=2)
    m = GDRecommender(80, 50, {'nbr_features': 6, 'min_epochs': 8,
                               'max_epochs': 8, 'engine': 'fused',
                               'learning_rate': 0.02, 'batch_size': 512})
    m.set_ratings(users, items, vals)
    m.train(handle_bias=True)
    return m


def test_server_endpoints():
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=1.0)
    port = srv.start()
    try:
        code, health = _get(port, '/health')
        assert code == 200 and health['ok'] and health['users'] == 80

        code, rec = _get(port, '/recommend?user=3&n=5')
        assert code == 200 and len(rec['items']) == 5
        assert len(rec['scores']) == 5
        # served list matches the model's own retrieval
        ids, _ = m.recommend_batch(np.array([3]), nbr_recommendations=5)
        assert rec['items'] == np.asarray(ids)[0].tolist()

        code, rec2 = _get(port, '/recommend?label=user3&n=5')
        assert rec2['items'] == rec['items']

        code, sim = _get(port, '/similar_items?item=7&n=4')
        assert code == 200 and len(sim['items']) == 4

        code, pred = _get(port, '/predict?user=3&item=7')
        assert code == 200
        assert abs(pred['score'] - float(m.predict_rating(7, 3))) < 1e-6

        # unknown label -> 404, not a crash
        code, err = _get(port, '/recommend?label=nosuch')
        assert code == 404

        # POST /rate ingests
        nnz0 = m.ratings.nnz
        req = urllib.request.Request(
            'http://127.0.0.1:%d/rate' % port,
            data=json.dumps({'user': 1, 'item': 2, 'value': 4.0}).encode(),
            method='POST')
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())['ok']
        assert m.ratings.nnz == nnz0 + 1
    finally:
        srv.stop()


def test_server_concurrent_requests_batch():
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=5.0)
    port = srv.start()
    try:
        results = {}

        def hit(u):
            _, rec = _get(port, '/recommend?user=%d&n=3' % u)
            results[u] = rec['items']

        threads = [threading.Thread(target=hit, args=(u,))
                   for u in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 12
        ids, _ = m.recommend_batch(np.arange(12), nbr_recommendations=3)
        ids = np.asarray(ids)
        for u in range(12):
            assert results[u] == ids[u].tolist()
    finally:
        srv.stop()


def test_server_reads_unblocked_by_write_stream():
    '''Snapshot-on-rate: a steady /rate stream must not stall retrieval
    (reads run lock-free against an immutable view), and writes become
    visible to readers after a view refresh.'''
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=1.0, view_refresh_ms=5.0)
    port = srv.start()
    try:
        nnz0 = m.ratings.nnz
        stop = threading.Event()
        write_count = [0]

        def writer():
            u = 0
            while not stop.is_set():
                req = urllib.request.Request(
                    'http://127.0.0.1:%d/rate' % port,
                    data=json.dumps({'user': u % 80, 'item': (u * 7) % 50,
                                     'value': 3.0}).encode(),
                    method='POST')
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert json.loads(r.read())['ok']
                write_count[0] += 1
                u += 1

        wt = threading.Thread(target=writer)
        wt.start()
        try:
            ok = 0
            import time
            t0 = time.monotonic()
            while time.monotonic() - t0 < 3.0:
                code, rec = _get(port, '/recommend?user=%d&n=3' % (ok % 80))
                assert code == 200 and len(rec['items']) == 3
                ok += 1
        finally:
            stop.set()
            wt.join(timeout=30)
        assert ok >= 20            # reads kept flowing under write load
        assert write_count[0] > 0
        # writes land in the live model immediately (some pairs may
        # overwrite existing ratings — dedup is last-write-wins)
        assert m.ratings.nnz >= nnz0
        # ...and reach readers once the view refreshes: user 0 rated
        # item 0 above, so a refreshed view must mask it out
        srv.refresh()
        code, rec = _get(port, '/recommend?user=0&n=20')
        assert 0 not in rec['items']
    finally:
        srv.stop()


def test_server_stop_rejects_submits():
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=1.0)
    srv.start()
    srv.stop()
    try:
        srv.batcher.submit(0, 3)
        assert False, 'submit after stop must raise'
    except RuntimeError:
        pass
    assert not srv.batcher.thread.is_alive()


def test_server_input_validation():
    '''Bad requests get 4xx without poisoning concurrent batches.'''
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=1.0)
    port = srv.start()
    try:
        code, err = _get(port, '/recommend?user=99999')
        assert code == 404
        code, err = _get(port, '/recommend?user=-1')
        assert code == 404              # negative would alias the last user
        code, err = _get(port, '/recommend')
        assert code == 400
        code, err = _get(port, '/recommend?user=abc')
        assert code == 400
        code, err = _get(port, '/similar_items?item=12345')
        assert code == 404
        code, err = _get(port, '/predict?user=1')
        assert code == 400
        # a valid request right after all those still works
        code, rec = _get(port, '/recommend?user=2&n=3')
        assert code == 200 and len(rec['items']) == 3
    finally:
        srv.stop()


def test_server_oversize_batch_splits_into_warmed_shape():
    '''A burst larger than pad_to must be served by SPLITTING into
    pad_to-sized device calls (one warmed shape — a bigger power-of-two
    shape would compile mid-traffic), with per-user
    results identical to the direct batched call.'''
    m = _make_model()
    srv = RecommenderServer(m, batch_window_ms=20.0, pad_to=4)
    port = srv.start()
    try:
        results = {}

        def hit(u):
            _, rec = _get(port, '/recommend?user=%d&n=3' % u)
            results[u] = rec['items']

        threads = [threading.Thread(target=hit, args=(u,))
                   for u in range(11)]           # 11 > pad_to=4
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 11
        ids, _ = m.recommend_batch(np.arange(11), nbr_recommendations=3)
        ids = np.asarray(ids)
        for u in range(11):
            assert results[u] == ids[u].tolist()
    finally:
        srv.stop()


