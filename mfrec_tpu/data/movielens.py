'''
Dataset loaders and synthetic generators.

``load_ratings_file`` replaces the reference example's ``np.loadtxt`` ingest
(``mfrec/examples/example1b_movielens_100k_wrmf.py:23``), with an optional
native C++ fast parser.  ``synthetic_ratings`` generates MovieLens-shaped
data with a planted low-rank structure for tests/benchmarks (the sandbox has
no network access, so the real MovieLens files may be absent).
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu.data.ratings import Ratings


def load_ratings_file(path, delimiter=None, use_native=True):
    '''Load a `user item rating [timestamp]` text file (MovieLens u.data
    format).  Returns (users[N] i32, items[N] i32, ratings[N] f32).'''
    if use_native:
        try:
            from mfrec_tpu.native import parse_ratings
            res = parse_ratings(path)
            if res is not None:
                return res
        except Exception:
            pass
    raw = np.loadtxt(path, delimiter=delimiter)
    return (raw[:, 0].astype(np.int32), raw[:, 1].astype(np.int32),
            raw[:, 2].astype(np.float32))


def load_ml100k_if_present(search_dirs=None):
    '''Real MovieLens-100K ``u1.base``/``u1.test`` split, when the files
    exist on disk (the reference's accuracy operating point —
    example1b_movielens_100k_wrmf.py:23-33).  Returns
    ``((users, items, values), test[N, 3])`` 0-indexed, or ``None`` when
    absent — callers (acceptance tests, bench self-validation) then fall
    back to the marginals-exact synthetic split
    (``mfrec_tpu.data.ml100k_like``).  Set ``MFREC_ML100K_DIR`` to point
    at a directory holding the two files.'''
    import os
    dirs = list(search_dirs or [])
    env = os.environ.get('MFREC_ML100K_DIR')
    if env:
        dirs.insert(0, env)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dirs += [os.path.join(here, 'data', 'ml-100k'),
             os.path.join(here, 'ml-100k'),
             '/root/data/ml-100k', '/data/ml-100k']
    for d in dirs:
        base = os.path.join(d, 'u1.base')
        test = os.path.join(d, 'u1.test')
        if not (os.path.isfile(base) and os.path.isfile(test)):
            continue
        u, i, v = load_ratings_file(base, delimiter='\t')
        tu, ti, tv = load_ratings_file(test, delimiter='\t')
        # MovieLens ids are 1-indexed
        train = (u - 1, i - 1, v)
        held = np.stack([tu - 1, ti - 1, tv], axis=1).astype(np.float64)
        return train, held
    return None


def _compact_ids(users, items, values):
    '''0-index and compact sparse id spaces (MovieLens 1M/10M movie ids
    have gaps up to ~65k for ~10k movies).'''
    uu, users = np.unique(users, return_inverse=True)
    ii, items = np.unique(items, return_inverse=True)
    return (users.astype(np.int32), items.astype(np.int32),
            np.asarray(values, np.float32))


def load_mldat_if_present(env='MFREC_ML10M_DIR', search_dirs=None,
                          filename='ratings.dat'):
    '''Real MovieLens-1M/10M ``ratings.dat`` (``UserID::MovieID::Rating::
    Timestamp``), when present (data is never downloaded; a checkout
    WITH the files needs zero code).
    Returns (users, items, values) 0-indexed/compacted, or None.
    Point ``MFREC_ML10M_DIR`` (or ``MFREC_ML1M_DIR``) at the directory.

    Parse path: stream-convert ``::`` to spaces into a temp file, then
    the native C++ parser (O(1) text memory); falls back to numpy.'''
    import os
    import tempfile
    dirs = list(search_dirs or [])
    e = os.environ.get(env)
    if e:
        dirs.insert(0, e)
    for d in dirs:
        path = os.path.join(d, filename)
        if not os.path.isfile(path):
            continue
        cache = path + '.npz'
        if os.path.isfile(cache) and \
                os.path.getmtime(cache) >= os.path.getmtime(path):
            z = np.load(cache)
            return z['u'], z['i'], z['v']
        with tempfile.NamedTemporaryFile(suffix='.txt', delete=False) \
                as tmp:
            with open(path, 'rb') as f:
                while True:
                    buf = f.read(1 << 23)
                    if not buf:
                        break
                    tmp.write(buf.replace(b'::', b' '))
            tmp_path = tmp.name
        try:
            u, i, v = load_ratings_file(tmp_path)
        finally:
            os.unlink(tmp_path)
        u, i, v = _compact_ids(u, i, v)
        try:
            np.savez(cache, u=u, i=i, v=v)
        except OSError:
            pass                      # read-only data dir: parse each time
        return u, i, v
    return None


def load_ml1m_if_present(search_dirs=None):
    return load_mldat_if_present(env='MFREC_ML1M_DIR',
                                 search_dirs=search_dirs)


def load_ml10m_if_present(search_dirs=None):
    return load_mldat_if_present(env='MFREC_ML10M_DIR',
                                 search_dirs=search_dirs)


def load_netflix_if_present(env='MFREC_NETFLIX_DIR', search_dirs=None):
    '''Netflix-prize ``combined_data_*.txt`` (``MovieID:`` header lines,
    then ``CustID,Rating,Date`` rows), when present.  Returns
    (users, items, values) 0-indexed/compacted, or None.  The one-time
    parse caches an ``.npz`` beside the files (100M rows; the cache
    loads in seconds, the parse in minutes).  Point
    ``MFREC_NETFLIX_DIR`` at the directory.'''
    import glob
    import os
    dirs = list(search_dirs or [])
    e = os.environ.get(env)
    if e:
        dirs.insert(0, e)
    for d in dirs:
        files = sorted(glob.glob(os.path.join(d, 'combined_data_*.txt')))
        if not files:
            continue
        cache = os.path.join(d, 'netflix_cache.npz')
        if os.path.isfile(cache):
            z = np.load(cache)
            return z['u'], z['i'], z['v']
        users, items, vals = [], [], []

        def parse_rows(rows, movie):
            if not rows:
                return
            # "CustID,Rating,YYYY-MM-DD" rows -> 5 numeric columns
            arr = np.fromstring(
                rows.replace(b',', b' ').replace(b'-', b' '),
                dtype=np.float64, sep=' ').reshape(-1, 5)
            users.append(arr[:, 0].astype(np.int64))
            vals.append(arr[:, 1].astype(np.float32))
            items.append(np.full(arr.shape[0], movie, np.int64))

        for path in files:
            with open(path, 'rb') as f:
                data = f.read()
            # "M:\n<rows>\nM':\n<rows>..." -> split(b':\n') yields the
            # first movie id, then blocks of "<rows>\n<next movie id>"
            # (the final block has no trailing id)
            blocks = data.split(b':\n')
            movie = int(blocks[0])
            for blk in blocks[1:]:
                nl = blk.rfind(b'\n')
                rows, nxt = (blk[:nl], blk[nl + 1:]) if nl >= 0 \
                    else (b'', blk)
                if b',' in nxt:          # final block, no trailing header
                    rows, nxt = blk.rstrip(b'\n'), b''
                parse_rows(rows, movie)
                if nxt:
                    movie = int(nxt)
        u = np.concatenate(users)
        i = np.concatenate(items)
        v = np.concatenate(vals)
        u, i, v = _compact_ids(u, i, v)
        try:
            np.savez(cache, u=u, i=i, v=v)
        except OSError:
            pass
        return u, i, v
    return None


def ratings_from_arrays(users, items, values, nbr_users=None, nbr_items=None):
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    values = np.asarray(values, np.float32)
    if nbr_users is None:
        nbr_users = int(users.max()) + 1
    if nbr_items is None:
        nbr_items = int(items.max()) + 1
    r = Ratings(nbr_users, nbr_items)
    r.set_many(users, items, values)
    return r


def synthetic_ratings(nbr_users=500, nbr_items=300, nbr_ratings=8000,
                      rank=6, seed=0, min_rating=1.0, max_rating=5.0,
                      zipf_items=1.1):
    '''Synthetic explicit-feedback ratings with planted low-rank structure.

    Users are sampled uniformly; item popularity follows a Zipf-like tail
    (like MovieLens).  True ratings = clipped affine map of a rank-`rank`
    factor model plus user/item biases and noise, rounded to half stars.
    Returns (users, items, values) with duplicates removed.
    '''
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 1.0, (nbr_users, rank))
    Q = rng.normal(0, 1.0, (nbr_items, rank))
    bu = rng.normal(0, 0.4, nbr_users)
    bi = rng.normal(0, 0.6, nbr_items)

    n_draw = int(nbr_ratings * 1.5)
    users = rng.integers(0, nbr_users, n_draw)
    ranks = np.arange(1, nbr_items + 1, dtype=np.float64)
    pop = 1.0 / ranks ** zipf_items
    pop /= pop.sum()
    item_order = rng.permutation(nbr_items)
    items = item_order[rng.choice(nbr_items, n_draw, p=pop)]

    key = users.astype(np.int64) * nbr_items + items
    _, first = np.unique(key, return_index=True)
    # a RANDOM subset of the unique pairs: np.unique returns indices in
    # key order, so truncating directly would keep only the smallest
    # (user, item) keys — silently dropping every high-id user from the
    # dataset (a "300-user" draw kept ~207 rated users)
    first = rng.permutation(first)[:nbr_ratings]
    users, items = users[first], items[first]

    mu = (min_rating + max_rating) / 2.0
    scale = (max_rating - min_rating) / 6.0
    raw = (P[users] * Q[items]).sum(-1) / np.sqrt(rank)
    vals = mu + scale * (raw + bu[users] + bi[items]) + rng.normal(0, 0.3, users.shape[0])
    vals = np.clip(np.round(vals * 2) / 2, min_rating, max_rating)
    # avoid explicit zeros which a sparse store would drop
    vals[vals == 0.0] = min_rating
    return users.astype(np.int32), items.astype(np.int32), vals.astype(np.float32)


def train_test_split(users, items, values, test_fraction=0.2, seed=0):
    rng = np.random.default_rng(seed)
    n = users.shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    train = (users[tr], items[tr], values[tr])
    test = np.stack([users[te].astype(np.float64),
                     items[te].astype(np.float64),
                     values[te].astype(np.float64)], axis=1)
    return train, test
