'''Mesh-sharded top-N retrieval (SURVEY §2.5 "Top-N retrieval at scale"):
per-shard top-k + all_gather + global re-rank must be result-identical to
the single-device path, with exact rated-item masking across shards.'''
import numpy as np
import jax
import jax.numpy as jnp

from mfrec_tpu.data.movielens import ratings_from_arrays
from mfrec_tpu.ops import topk as topk_ops
from mfrec_tpu.parallel.topn_sharded import sharded_topn


def _setup(seed=0, B=16, I=403, K=8, L=25):
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.3, (B, K)).astype(np.float32)
    Q = rng.normal(0, 0.3, (I, K)).astype(np.float32)
    bu = rng.normal(0, 0.1, B).astype(np.float32)
    bi = rng.normal(0, 0.1, I).astype(np.float32)
    rated_idx = rng.integers(0, I, (B, L)).astype(np.int32)
    rated_mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    return P, Q, bu, bi, rated_idx, rated_mask


def test_sharded_matches_single_chip():
    P, Q, bu, bi, ridx, rmask = _setup()
    n, mu = 7, 3.1
    want_i, want_s = topk_ops.topn_scores(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(bu), jnp.asarray(bi),
        jnp.float32(mu), jnp.asarray(ridx), jnp.asarray(rmask), n,
        block=128, predictor='bias')
    got_i, got_s = sharded_topn(P, Q, bu, bi, mu, ridx, rmask, n,
                                block=128, predictor='bias')
    np.testing.assert_allclose(np.asarray(want_s), got_s, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(want_i), got_i)


def test_sharded_masks_rated_across_shards():
    '''Rated ids land in different shards; none may be recommended.'''
    P, Q, bu, bi, ridx, rmask = _setup(seed=3)
    idx, sc = sharded_topn(P, Q, bu, bi, 3.0, ridx, rmask, 10,
                           block=128, predictor='bias')
    for b in range(P.shape[0]):
        rated = set(ridx[b][rmask[b] > 0].tolist())
        assert not (set(idx[b].tolist()) & rated)


def test_recommend_batch_sharded_auto(small_dataset):
    '''Model-level: recommend_batch auto-shards on the 8-device mesh and
    matches the explicit single-chip result.'''
    from mfrec_tpu.models.gd import GDRecommender
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = GDRecommender(U, I, {'min_epochs': 5, 'max_epochs': 5,
                             'nbr_features': 6, 'learning_rate': 0.02,
                             'batch_size': 1024})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)
    users = [0, 3, 7, 11]
    assert len(jax.devices()) == 8     # conftest virtual mesh
    ids_sh, sc_sh = m.recommend_batch(users, 5,
                                      predictor='predict_rating_with_bias')
    ids_1, sc_1 = m.recommend_batch(users, 5, sharded=False,
                                    predictor='predict_rating_with_bias')
    np.testing.assert_array_equal(ids_sh, ids_1)
    np.testing.assert_allclose(sc_sh, sc_1, rtol=1e-5, atol=1e-5)
    # rated items masked
    for r, uu in enumerate(users):
        rated = set(np.nonzero(m.ratings.rated_mask_for_user(uu))[0])
        assert not (set(ids_sh[r].tolist()) & rated)


