'''``ops.topk.topn_scores`` — the single retrieval path — against a numpy
brute force for every predictor mode, with rated-item masking.'''
import numpy as np
import pytest
import jax.numpy as jnp

from mfrec_tpu.ops import topk as topk_ops


def _scores_np(P, Q, bu, bi, mu, mode, lo=1.0, hi=5.0):
    dot = P.astype(np.float64) @ Q.astype(np.float64).T
    if mode == 'dot_plus_one':
        return dot + 1.0
    if mode == 'dot':
        return dot
    if mode == 'bias':
        return mu + bu[:, None] + bi[None, :] + dot
    z = dot + bu[:, None] + bi[None, :]
    return lo + (hi - lo) / (1.0 + np.exp(-z))


@pytest.mark.parametrize('mode', ['dot_plus_one', 'dot', 'bias',
                                  'logistic'])
def test_topn_scores_matches_brute_force(mode):
    rng = np.random.default_rng(4)
    B, I, K, L, n = 12, 1000, 16, 30, 10
    P = rng.normal(0, 0.4, (B, K)).astype(np.float32)
    Q = rng.normal(0, 0.4, (I, K)).astype(np.float32)
    bu = rng.normal(0, 0.2, B).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    ridx = rng.integers(0, I, (B, L)).astype(np.int32)
    rmask = (rng.random((B, L)) > 0.2).astype(np.float32)
    idx, sc = topk_ops.topn_scores(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(bu), jnp.asarray(bi),
        jnp.float32(3.2), jnp.asarray(ridx), jnp.asarray(rmask), n,
        block=256, predictor=mode)
    idx, sc = np.asarray(idx), np.asarray(sc)
    full = _scores_np(P, Q, bu, bi, 3.2, mode)
    for b in range(B):
        full[b, ridx[b][rmask[b] > 0]] = -np.inf       # rated: masked
        want = np.argsort(-full[b], kind='stable')[:n]
        assert set(idx[b]) == set(want), (mode, b)
        assert not set(idx[b]) & set(ridx[b][rmask[b] > 0])
        # float32 scores vs the float64 brute force
        np.testing.assert_allclose(sc[b], full[b, idx[b]], rtol=1e-5,
                                   atol=1e-5)
        assert (np.diff(sc[b]) <= 0).all()
