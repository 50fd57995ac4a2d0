'''Round-5 fixes: per-train() fixed-cost removal on the public API path
+ review items.

The model path had two per-train() components the ops-level bench never
paid: a fresh jitted-epoch closure per train() call (a full recompile)
and an O(nnz) host
layout re-sort + device re-upload.  Both are now cached: epoch builders
memoize on their static config (``sgd_mf._memo_epoch_builder``) and the
sorted-pass layouts cache on the ratings snapshot version
(``MFRecommender._alternating_layouts``).
'''
import numpy as np
import pytest

from mfrec_tpu.data.movielens import synthetic_ratings
from mfrec_tpu.models.base import Error
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.ops import sgd_mf


def _model(u, i, v, **over):
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'nbr_features': 6, 'min_epochs': 2, 'max_epochs': 2,
              'min_improvement': -1.0, 'batch_size': 512,
              'inner_steps': 2, 'engine': 'alternating'}
    params.update(over)
    m = GDRecommender(U, I, params)
    m.set_ratings(u.astype(np.int32), i.astype(np.int32),
                  v.astype(np.float32))
    return m


@pytest.fixture(scope='module')
def data():
    return synthetic_ratings(nbr_users=120, nbr_items=80, nbr_ratings=3000,
                             rank=4, seed=11)


# ---------------------------------------------------------- ratings version
def test_ratings_version_stable_until_mutation(data):
    u, i, v = data
    m = _model(u, i, v)
    v0 = m.ratings.version
    assert m.ratings.version == v0          # reads do not bump
    m.ratings.coo()
    assert m.ratings.version == v0
    m.ratings.set(0, 0, 3.5)
    assert m.ratings.version != v0          # mutation bumps
    v1 = m.ratings.version
    m.ratings.grow(nbr_items=200)
    assert m.ratings.version != v1


# ------------------------------------------------------------- layout cache
def test_alternating_layouts_cached_across_trains(data):
    u, i, v = data
    m = _model(u, i, v)
    l1 = m._alternating_layouts(32)
    l2 = m._alternating_layouts(32)
    assert l1 is l2                          # same snapshot -> same object
    assert m._alternating_layouts(64) is not l1   # window is part of the key
    m.ratings.set(1, 1, 4.0)
    l3 = m._alternating_layouts(32)
    assert l3 is not l1                      # mutation invalidates

    # the rebuilt layout must cover the new rating
    ub, ib, rb, mb, kl, lo = l3[0]
    assert int(np.asarray(mb).sum()) == m.ratings.nnz


def test_train_twice_reuses_layouts_and_epoch(data):
    '''Two train() calls on unchanged ratings must not redo the O(nnz)
    host layout build (the r4 per-train fixed cost).'''
    u, i, v = data
    m = _model(u, i, v)
    m.train(handle_bias=True)
    cache1 = m._alt_layout_cache
    rmse1 = list(m.rmse_history)
    m.train(handle_bias=True)
    assert m._alt_layout_cache is cache1     # untouched entry, no rebuild
    assert len(m.rmse_history) == len(rmse1)


# ---------------------------------------------------------- builder memo
def test_epoch_builder_memoized():
    a = sgd_mf.make_alternating_epoch(8, 8, 0.1, 0.02, inner_steps=2,
                                      chunk=256)
    b = sgd_mf.make_alternating_epoch(8, 8, 0.1, 0.02, inner_steps=2,
                                      chunk=256)
    c = sgd_mf.make_alternating_epoch(8, 8, 0.1, 0.02, inner_steps=3,
                                      chunk=256)
    assert a is b and a is not c


def test_epoch_builder_memo_results_identical(data):
    '''A memo-hit epoch trains identically to a fresh build (the memo key
    covers every numerics-relevant arg).'''
    u, i, v = data
    pl_ = sgd_mf.sorted_pass_layout(u, i, v, 512, axis='user',
                                    max_window=32)
    ql_ = sgd_mf.sorted_pass_layout(u, i, v, 512, axis='item',
                                    max_window=32)
    W_user, W_item = pl_[-1], ql_[-1]
    import jax.numpy as jnp
    p_layout = tuple(jnp.asarray(x) for x in pl_[:-1])
    q_layout = tuple(jnp.asarray(x) for x in ql_[:-1])
    U, I = int(u.max()) + 1, int(i.max()) + 1
    st = sgd_mf.init_state(U + W_user, I + W_item, 6, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(st.P, st.Q, st.bu, st.bi)
    mu = jnp.float32(v.mean())
    outs = []
    for _ in range(2):     # second call is a memo hit
        ep = sgd_mf.make_alternating_epoch(W_user, W_item, 0.15, 0.02,
                                           bias_mode='fixed', chunk=512,
                                           donate=False, inner_steps=2)
        Pa, Qa, rmse = ep(Paug, Qaug, mu, p_layout, q_layout)
        outs.append((np.asarray(Pa), float(rmse)))
    assert outs[0][1] == outs[1][1]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


def test_epoch_builder_memo_unhashable_bypasses():
    calls = []

    @sgd_mf._memo_epoch_builder
    def build(cfg):
        calls.append(cfg)
        return object()

    probe = ['not-hashable-config']
    a, b = build(probe), build(probe)
    assert a is not b and len(calls) == 2    # no memo for unhashable args
    assert build('hashable') is build('hashable') and len(calls) == 3


# ------------------------------------------------- padded-list unification
def test_padded_segment_gather_contract():
    '''The shared core behind fn.padded_user_lists / topk.pad_rated_lists
    / Ratings.padded_rows.'''
    from mfrec_tpu.data.ratings import padded_segment_gather
    ptr = np.array([0, 2, 2, 5], np.int64)           # rows: 2, 0, 3 entries
    items = np.array([7, 3, 9, 1, 4], np.int32)
    vals = np.array([1., 2., 3., 4., 5.], np.float32)
    idx, v, mask = padded_segment_gather(ptr, [0, 1, 2], 2, items, vals)
    np.testing.assert_array_equal(idx, [[7, 3], [0, 0], [9, 1]])  # L caps row 2
    np.testing.assert_array_equal(v, [[1., 2.], [0., 0.], [3., 4.]])
    np.testing.assert_array_equal(mask, [[1., 1.], [0., 0.], [1., 1.]])
    # arbitrary/repeated row subsets (the pad_rated_lists use)
    idx2, m2 = padded_segment_gather(ptr, [2, 2], 4, items)
    np.testing.assert_array_equal(idx2, [[9, 1, 4, 0]] * 2)
    np.testing.assert_array_equal(m2, [[1., 1., 1., 0.]] * 2)
    assert idx2.dtype == np.int32 and m2.dtype == np.float32
    # empty store
    e_idx, e_mask = padded_segment_gather(np.zeros(3, np.int64), [0, 1], 2,
                                          np.zeros(0, np.int32))
    assert e_idx.shape == (2, 2) and not e_mask.any()


def test_padded_builders_agree_on_shared_core(data):
    '''fn.padded_user_lists and Ratings.padded_rows must expose identical
    per-row contents for the same store (different grouping only).'''
    from mfrec_tpu.data.movielens import ratings_from_arrays
    from mfrec_tpu.ops.fn import padded_user_lists
    u, i, v = data
    r = ratings_from_arrays(u, i, v, int(u.max()) + 1, int(i.max()) + 1)
    fl, fv, fm = padded_user_lists(r)
    for rows, idx, vals, mask in r.padded_rows(axis='user'):
        for j, row in enumerate(rows):
            n = int(mask[j].sum())
            assert n == int(fm[row].sum())
            np.testing.assert_array_equal(idx[j, :n], fl[row, :n])
            np.testing.assert_array_equal(vals[j, :n], fv[row, :n])


# -------------------------------------------- batched mode-None retrieval
def _loop_vs_hook(model, users, monkeypatch):
    '''find_recommended_items with the vectorized hook vs the forced
    per-item python loop — ids and scores must agree.'''
    got = {u: model.find_recommended_items(user_index=u,
                                           nbr_recommendations=5)
           for u in users}
    monkeypatch.setattr(type(model), '_score_unrated_host',
                        lambda self, u, p: None)
    for u in users:
        ids_l, sc_l = model.find_recommended_items(user_index=u,
                                                   nbr_recommendations=5)
        ids_h, sc_h = got[u]
        assert ids_h == ids_l, (u, ids_h, ids_l)
        np.testing.assert_allclose(sc_h, sc_l, rtol=1e-5, atol=1e-6)


def test_svd_mode_none_retrieval_matches_loop(data, monkeypatch):
    from mfrec_tpu.models.svd import SVDRecommender
    u, i, v = data
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = SVDRecommender(U, I, {'nbr_features': 8})
    m.set_ratings(u.astype(np.int32), i.astype(np.int32),
                  v.astype(np.float32))
    m.train()
    _loop_vs_hook(m, [0, 3, 7], monkeypatch)


def test_knn_svd_mode_none_retrieval_matches_loop(data, monkeypatch):
    from mfrec_tpu.models.knn_svd import KNNSVDRecommender
    u, i, v = data
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = KNNSVDRecommender(U, I, {'nbr_features': 8, 'k': 10, 'k_min': 2})
    m.set_ratings(u.astype(np.int32), i.astype(np.int32),
                  v.astype(np.float32))
    m.train()
    _loop_vs_hook(m, [0, 3, 7], monkeypatch)
    # recommend_batch's mode-None branch rides the same hook
    idx, sc = m.recommend_batch([0, 3], nbr_recommendations=5)
    assert idx.shape == (2, 5)


# ---------------------------------------------- file-if-present loaders
def test_load_mldat_parses_and_caches(tmp_path):
    '''ML-1M/10M ratings.dat ("::" separators), 0-indexed + compacted.'''
    from mfrec_tpu.data.movielens import load_mldat_if_present
    p = tmp_path / 'ratings.dat'
    p.write_text('1::122::5::838985046\n'
                 '1::185::3.5::838983525\n'
                 '7::122::4::838983392\n'
                 '9::9000::2::838983392\n')
    u, i, v = load_mldat_if_present(search_dirs=[str(tmp_path)])
    np.testing.assert_array_equal(u, [0, 0, 1, 2])     # compacted users
    np.testing.assert_array_equal(i, [0, 1, 0, 2])     # compacted items
    np.testing.assert_allclose(v, [5.0, 3.5, 4.0, 2.0])
    assert (tmp_path / 'ratings.dat.npz').exists()     # cache written
    u2, i2, v2 = load_mldat_if_present(search_dirs=[str(tmp_path)])
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_allclose(v, v2)


def test_load_mldat_absent_returns_none(tmp_path):
    from mfrec_tpu.data.movielens import load_mldat_if_present
    assert load_mldat_if_present(search_dirs=[str(tmp_path)]) is None


def test_load_netflix_parses_and_caches(tmp_path):
    from mfrec_tpu.data.movielens import load_netflix_if_present
    p = tmp_path / 'combined_data_1.txt'
    p.write_text('1:\n'
                 '1488844,3,2005-09-06\n'
                 '822109,5,2005-05-13\n'
                 '2:\n'
                 '822109,4,2005-01-02\n'
                 '30878,4,2005-12-19\n')
    u, i, v = load_netflix_if_present(search_dirs=[str(tmp_path)])
    assert u.shape == (4,)
    # items compacted: movie 1 -> 0, movie 2 -> 1
    np.testing.assert_array_equal(i, [0, 0, 1, 1])
    np.testing.assert_allclose(v, [3, 5, 4, 4])
    # user 822109 appears under both movies with the same compact id
    assert u[1] == u[2]
    assert (tmp_path / 'netflix_cache.npz').exists()
    u2, _, _ = load_netflix_if_present(search_dirs=[str(tmp_path)])
    np.testing.assert_array_equal(u, u2)


# ------------------------------------------------------------ review items
def test_feature_init_zero_raises(data):
    u, i, v = data
    m = _model(u, i, v, feature_init=0.0)
    with pytest.raises(Error):
        m.train(handle_bias=True)


def test_sweep_seed_threads_into_batches(data):
    '''optimize_regularization_vmapped(seed=...) must vary the batch
    shuffle, not only the init draw.'''
    from mfrec_tpu.eval.sweep import optimize_regularization_vmapped
    u, i, v = data
    test = np.stack([u[:50], i[:50], v[:50]], axis=1)
    out = {}
    for seed in (0, 1):
        regs, rmses = optimize_regularization_vmapped(
            u, i, v, test, regs=(0.02, 0.1), rank=4, epochs=2,
            batch_size=256, lr=0.01, seed=seed)
        out[seed] = np.asarray(rmses)
    assert not np.array_equal(out[0], out[1])
