'''
Lightweight model-serving front: a stdlib HTTP server over a trained
recommender.

The reference's serving story is exporting factors to MongoDB/neo4j for
an external app to read (``base.py:599-794``).  Here the trained model
serves directly — requests hit the batched device retrieval path
(``MFRecommender.recommend_batch``: blocked P@Q^T + fused top-k,
mesh-sharded when >1 device), so one process covers the whole
retrieve-and-rank loop.  stdlib-only (ThreadingHTTPServer): no web
framework to pin, trivially replaceable by a real gateway in production.

Endpoints (all JSON):

  GET /health                          -> {"ok": true, users, items}
  GET /recommend?user=3&n=10           -> {"user": 3, "items": [...],
                                           "scores": [...]}
  GET /recommend?label=user3&n=10      -> same, label-addressed
  GET /similar_items?item=7&n=5        -> {"item": 7, "items": [...],
                                           "scores": [...]}
  GET /predict?user=3&item=7           -> {"user": 3, "item": 7,
                                           "score": ...}
  POST /rate  {"user": 3, "item": 7, "value": 4.5}
      -> ingest one rating (fold-in retraining stays an offline call:
         ``add_user``/``retrain_user``)

Concurrency model — snapshot-on-rate: every read path (recommend,
similar_items, predict) runs lock-free against an immutable serving
view (shallow model copy over a frozen, pre-consolidated ratings
snapshot).  ``/rate`` appends to the live model under a write lock and
marks the view stale; a refresher thread swaps in a fresh view at most
every ``view_refresh_ms`` — so a steady write stream never stalls the
read path (the ratings store's lazy consolidation is the only shared
mutable state, and readers never touch it).

Micro-batching: concurrent /recommend requests are coalesced into one
``recommend_batch`` device call (up to ``batch_window_ms``), padded to a
FIXED user-batch size and a fixed rated-list width, with per-request
``n`` bucketed — so the device sees a handful of stable shapes (a novel
shape per batch composition would recompile, stalling every waiter in
its compile window).  Pass
``warmup=True`` (default) to compile the steady-state shape before the
server accepts traffic.
'''
from __future__ import annotations

import copy
import json
import logging
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mfrec_tpu.data.ratings import Ratings
from mfrec_tpu.models.base import Error


class _FrozenRatings(Ratings):
    '''Read-only, pre-consolidated ratings snapshot.  Shares the source
    store's consolidated arrays (immutable by convention) so building a
    view costs one consolidation, not a copy.'''

    def __init__(self, ratings):
        u, i, v = ratings.coo()          # consolidates the live store
        Ratings.__init__(self, ratings.nbr_users, ratings.nbr_items)
        self._u, self._i, self._v = u, i, v

    def set(self, *a, **k):
        raise Error('serving snapshot is read-only; POST /rate writes '
                    'to the live model')

    set_many = set
    grow = set


class _ServingView:
    '''Immutable read view: shallow model copy bound to a frozen ratings
    snapshot, plus the fixed rated-list pad width that keeps the
    retrieval program's shapes stable across batches.'''

    def __init__(self, model):
        self.model = copy.copy(model)
        self.model.ratings = _FrozenRatings(model.ratings)
        counts = self.model.ratings.user_counts()
        cmax = int(counts.max()) if counts.size else 1
        self.rated_pad = 1 << max(cmax - 1, 0).bit_length()


class _Batcher:
    '''Coalesce concurrent single-user retrieval requests into one
    batched device call against the current serving view.'''

    def __init__(self, view_fn, nbr_recommendations, window_ms, max_batch,
                 pad_to=None, submit_timeout_s=600.0):
        self.view_fn = view_fn
        self.n = int(nbr_recommendations)
        self.window_s = window_ms / 1000.0
        self.max_batch = int(max_batch)
        # fixed device batch size: every device call uses exactly this
        # shape — oversize batches are SPLIT into pad_to-sized chunks
        # (one warmed shape, zero runtime compile stalls) rather than
        # padded up to a never-warmed power of two
        self.pad_to = int(pad_to) if pad_to else min(self.max_batch, 256)
        self.submit_timeout_s = float(submit_timeout_s)
        self.q = queue.Queue()
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def bucket_n(self, n, nbr_items):
        '''Clamp per-request n to a small fixed set (the configured n,
        then powers of two) so novel n values don't each compile a fresh
        device program.'''
        n = max(int(n), 1)
        if n <= self.n:
            return self.n
        return min(1 << (n - 1).bit_length(), int(nbr_items))

    def submit(self, user_index, n):
        if self._stop:
            raise RuntimeError('server shutting down')
        ev = threading.Event()
        slot = {'user': int(user_index), 'n': int(n), 'ev': ev}
        self.q.put(slot)
        if self._stop:
            # close the put-after-final-drain race: if shutdown raced
            # this enqueue, fail the slot ourselves — a double ev.set()
            # from the loop is harmless, and during shutdown an error
            # beats a silent 10-minute hang
            slot.setdefault('error', 'server shutting down')
            ev.set()
        if not ev.wait(timeout=self.submit_timeout_s):
            raise RuntimeError('batched retrieval timed out')
        if 'error' in slot:
            raise RuntimeError(slot['error'])
        return slot['items'], slot['scores']

    def _run_batch(self, batch):
        # split into pad_to-sized chunks: every device call uses the ONE
        # warmed batch shape (an oversize power-of-two shape would
        # compile mid-traffic, stalling every coalesced waiter — the
        # exact failure warmup exists to prevent)
        for lo in range(0, len(batch), self.pad_to):
            self._run_chunk(batch[lo:lo + self.pad_to])

    def _run_chunk(self, batch):
        view = self.view_fn()
        users = [s['user'] for s in batch]
        n_dev = max(self.bucket_n(s['n'], view.model.nbr_items)
                    for s in batch)
        B = self.pad_to
        padded = users + [users[0]] * (B - len(users))
        try:
            ids, scores = view.model.recommend_batch(
                np.asarray(padded, np.int64), nbr_recommendations=n_dev,
                rated_pad_to=view.rated_pad)
            ids, scores = np.asarray(ids), np.asarray(scores)
            for j, s in enumerate(batch):
                s['items'] = ids[j][:s['n']].tolist()
                s['scores'] = [float(x) for x in scores[j][:s['n']]]
        except Exception as e:          # surface to every waiter
            for s in batch:
                s['error'] = repr(e)
        for s in batch:
            s['ev'].set()

    def _loop(self):
        while True:
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                if self._stop:
                    break
                continue
            if first is None:                    # shutdown sentinel
                break
            batch = [first]
            time.sleep(self.window_s)      # batching window
            while len(batch) < self.max_batch:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop = True
                    break
                batch.append(nxt)
            self._run_batch(batch)
            if self._stop:
                break
        # drain: fail anything still queued so waiters return promptly
        # instead of sitting out the submit timeout
        while True:
            try:
                s = self.q.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                s['error'] = 'server shutting down'
                s['ev'].set()

    def stop(self):
        self._stop = True
        self.q.put(None)
        self.thread.join(timeout=10)
        # second drain AFTER the join: completes slots that raced past
        # the loop's own drain (put between its last get and thread exit)
        while True:
            try:
                slot = self.q.get_nowait()
            except queue.Empty:
                break
            if slot is not None:
                slot.setdefault('error', 'server shutting down')
                slot['ev'].set()


class RecommenderServer:
    '''HTTP serving wrapper around a trained recommender.'''

    def __init__(self, model, host='127.0.0.1', port=0,
                 nbr_recommendations=10, batch_window_ms=2.0,
                 max_batch=1024, pad_to=None, submit_timeout_s=600.0,
                 view_refresh_ms=50.0, warmup=True):
        self.model = model
        self.logger = logging.getLogger('mfrec_tpu.serving')
        # the write lock guards live-model mutation + view rebuild only;
        # reads go through the immutable view and never take it
        self._write_lock = threading.Lock()
        self.view = _ServingView(model)
        self.view_refresh_s = view_refresh_ms / 1000.0
        self._stale = threading.Event()
        self._closed = False
        self._refresher = threading.Thread(target=self._refresh_loop,
                                           daemon=True)
        self._refresher.start()
        self.batcher = _Batcher(lambda: self.view, nbr_recommendations,
                                batch_window_ms, max_batch, pad_to=pad_to,
                                submit_timeout_s=submit_timeout_s)
        if warmup:
            self._warmup()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet; use logging if needed
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    url = urllib.parse.urlparse(self.path)
                    q = dict(urllib.parse.parse_qsl(url.query))
                    view = server.view
                    if url.path == '/health':
                        return self._json(200, {
                            'ok': True,
                            'users': view.model.nbr_users,
                            'items': view.model.nbr_items})
                    if url.path == '/recommend':
                        if 'label' in q:
                            user = view.model.users.index[q['label']]
                        elif 'user' in q:
                            user = int(q['user'])
                        else:
                            return self._json(400, {
                                'error': "need 'user' or 'label'"})
                        if not 0 <= int(user) < view.model.nbr_users:
                            # reject here: an invalid id inside a
                            # coalesced batch would otherwise 500 every
                            # concurrent request in its window (and
                            # negative ids would silently alias another
                            # user through numpy indexing)
                            return self._json(404, {
                                'error': 'unknown user %s' % user})
                        n = int(q.get('n', server.batcher.n))
                        items, scores = server.batcher.submit(user, n)
                        return self._json(200, {'user': int(user),
                                                'items': items,
                                                'scores': scores})
                    if url.path == '/similar_items':
                        if 'item' not in q:
                            return self._json(400, {'error': "need 'item'"})
                        item = int(q['item'])
                        if not 0 <= item < view.model.nbr_items:
                            return self._json(404, {
                                'error': 'unknown item %d' % item})
                        n = int(q.get('n', 5))
                        ids, sims = view.model.similar_items(
                            item, nbr_recommendations=n,
                            similarities_output=True)
                        return self._json(200, {
                            'item': item,
                            'items': [int(i) for i in ids],
                            'scores': [float(s) for s in sims]})
                    if url.path == '/predict':
                        if 'user' not in q or 'item' not in q:
                            return self._json(400, {
                                'error': "need 'user' and 'item'"})
                        user, item = int(q['user']), int(q['item'])
                        if not (0 <= user < view.model.nbr_users
                                and 0 <= item < view.model.nbr_items):
                            return self._json(404, {'error': 'unknown id'})
                        score = float(view.model.predict(item, user))
                        return self._json(200, {'user': user, 'item': item,
                                                'score': score})
                    return self._json(404, {'error': 'unknown path'})
                except KeyError as e:
                    return self._json(404, {'error': 'unknown id %s' % e})
                except ValueError as e:
                    return self._json(400, {'error': 'bad parameter: %s' % e})
                except Exception as e:
                    return self._json(500, {'error': repr(e)})

            def do_POST(self):
                try:
                    url = urllib.parse.urlparse(self.path)
                    length = int(self.headers.get('Content-Length', 0))
                    payload = json.loads(self.rfile.read(length) or b'{}')
                    if url.path == '/rate':
                        with server._write_lock:
                            server.model.set_item_by_id(
                                int(payload['user']), int(payload['item']),
                                float(payload['value']))
                        server._stale.set()
                        return self._json(200, {'ok': True})
                    return self._json(404, {'error': 'unknown path'})
                except Exception as e:
                    return self._json(500, {'error': repr(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = None

    def _refresh_loop(self):
        '''Swap in a fresh serving view after writes, at most once per
        refresh window — bounds consolidation cost under a write stream
        and keeps readers entirely lock-free.'''
        while True:
            self._stale.wait()
            if self._closed:
                break
            self._stale.clear()
            time.sleep(self.view_refresh_s)     # coalesce write bursts
            with self._write_lock:
                try:
                    self.view = _ServingView(self.model)
                except Exception:
                    # keep serving the old view, but re-mark stale so
                    # the refresher retries (next iteration sleeps the
                    # refresh window first — a bounded backoff) instead
                    # of pinning readers to the stale view until the
                    # next write
                    self.logger.exception('serving view rebuild failed; '
                                          'will retry')
                    self._stale.set()

    def refresh(self, timeout=10.0):
        '''Block until pending writes are visible to readers (test/ops
        hook; normal operation relies on the background refresher).'''
        deadline = time.monotonic() + timeout
        while self._stale.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        with self._write_lock:
            # clear BEFORE rebuilding (same order as _refresh_loop): a
            # write landing mid-rebuild re-sets the flag and gets its
            # own refresh; without the clear, the background refresher
            # redundantly rebuilds this identical view right after
            self._stale.clear()
            self.view = _ServingView(self.model)

    def _warmup(self):
        '''Compile the steady-state retrieval shape before taking
        traffic (without warmup every waiter in the first compile window
        would stall behind it).'''
        view = self.view
        b = self.batcher
        users = np.zeros(b.pad_to, np.int64)
        try:
            view.model.recommend_batch(users, nbr_recommendations=b.n,
                                       rated_pad_to=view.rated_pad)
        except Exception:
            pass            # warmup is best-effort; requests still work

    def start(self):
        '''Serve in a background thread; returns the bound port.'''
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        self.batcher.stop()
        self._closed = True
        self._stale.set()
        self._refresher.join(timeout=10)
        if self._thread:
            # shutdown() blocks until serve_forever() exits its loop —
            # calling it when start() never ran deadlocks forever
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def serve(model, host='127.0.0.1', port=8080, **kw):
    '''Blocking convenience entry: serve `model` until interrupted.'''
    s = RecommenderServer(model, host=host, port=port, **kw)
    print('serving on %s:%d' % (host, s.port))
    try:
        s.httpd.serve_forever()
    except KeyboardInterrupt:
        s.stop()
