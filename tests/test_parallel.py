'''Multi-chip paths on the 8-device virtual CPU mesh: ring DSGD,
parameter averaging, sharded ALS.'''
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfrec_tpu.parallel.mesh import make_mesh
from mfrec_tpu.parallel import dsgd
from mfrec_tpu.parallel.als_sharded import make_sharded_als_epoch, \
    padded_uniform
from mfrec_tpu.data.movielens import ratings_from_arrays, synthetic_ratings


@pytest.fixture(scope='module')
def mesh8():
    assert len(jax.devices()) >= 8, 'conftest must provide 8 CPU devices'
    return make_mesh(8)


def test_dsgd_blocks_cover_everything():
    users, items, vals = synthetic_ratings(100, 60, 900, seed=9)
    (ub, ib, rb, mb), (Ub, Ib) = dsgd.build_dsgd_blocks(
        users, items, vals, 4, 100, 60)
    assert int(mb.sum()) == users.shape[0]
    # local indices in range
    assert ub.max() < Ub and ib.max() < Ib
    # reconstruct global pairs and compare as sets
    got = set()
    for du in range(4):
        for di in range(4):
            sel = mb[du, di] > 0
            gu = ub[du, di][sel] + du * Ub
            gi = ib[du, di][sel] + di * Ib
            got |= set(zip(gu.tolist(), gi.tolist()))
    assert got == set(zip(users.tolist(), items.tolist()))


def test_ring_dsgd_trains(mesh8):
    D = 8
    users, items, vals = synthetic_ratings(200, 120, 4000, rank=5, seed=10)
    (ub, ib, rb, mb), (Ub, Ib) = dsgd.build_dsgd_blocks(
        users, items, vals, D, 200, 120)
    k = 6
    P = jnp.asarray(dsgd.pad_factors(np.full((200, k), 0.1, np.float32),
                                     Ub, D))
    Q = jnp.asarray(dsgd.pad_factors(np.full((120, k), 0.1, np.float32),
                                     Ib, D))
    bu = jnp.zeros(D * Ub, jnp.float32)
    bi = jnp.zeros(D * Ib, jnp.float32)
    mu = jnp.float32(vals.mean())
    epoch = dsgd.make_ring_dsgd_epoch(mesh8, lr=0.02, K=0.02,
                                      bias_mode='fixed')
    hist = []
    for _ in range(20):
        P, Q, bu, bi, rmse = epoch(P, Q, bu, bi, mu,
                                   jnp.asarray(ub), jnp.asarray(ib),
                                   jnp.asarray(rb), jnp.asarray(mb))
        hist.append(float(rmse))
    assert hist[-1] < hist[0]
    assert np.isfinite(np.asarray(P)).all()
    # item shards must have rotated full circle: prediction sanity
    pred = np.asarray(P[:200]) @ np.asarray(Q[:120]).T + float(mu)
    dense_err = []
    for u, i, v in zip(users[:500], items[:500], vals[:500]):
        dense_err.append(v - pred[u, i])
    assert np.sqrt(np.mean(np.square(dense_err))) < hist[0]


def test_ring_dsgd_deterministic(mesh8):
    users, items, vals = synthetic_ratings(100, 60, 1500, seed=11)
    (blocks, (Ub, Ib)) = dsgd.build_dsgd_blocks(users, items, vals, 8,
                                                100, 60)
    k = 4
    args = [jnp.asarray(dsgd.pad_factors(np.full((100, k), 0.1, np.float32),
                                         Ub, 8)),
            jnp.asarray(dsgd.pad_factors(np.full((60, k), 0.1, np.float32),
                                         Ib, 8)),
            jnp.zeros(8 * Ub, jnp.float32), jnp.zeros(8 * Ib, jnp.float32),
            jnp.float32(3.0)] + [jnp.asarray(b) for b in blocks]
    epoch = dsgd.make_ring_dsgd_epoch(make_mesh(8), lr=0.01, K=0.02)
    out1 = epoch(*args)
    out2 = epoch(*args)
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))
    np.testing.assert_array_equal(np.asarray(out1[1]), np.asarray(out2[1]))


def test_zinkevich_averaging_trains(mesh8):
    users, items, vals = synthetic_ratings(150, 90, 3000, rank=5, seed=12)
    D = 8
    shards = dsgd.shard_ratings_for_averaging(users, items, vals, D, seed=0)
    k = 6
    P = jnp.full((150, k), 0.1, jnp.float32)
    Q = jnp.full((90, k), 0.1, jnp.float32)
    epoch = dsgd.make_zinkevich_epoch(mesh8, lr=0.02, K=0.02)
    hist = []
    for _ in range(15):
        P, Q, rmse = epoch(P, Q, jnp.float32(0.0),
                           *[jnp.asarray(s) for s in shards])
        hist.append(float(rmse))
    assert hist[-1] < hist[0]


def test_sharded_als_matches_single_device(mesh8):
    users, items, vals = synthetic_ratings(64, 40, 600, seed=13)
    r = ratings_from_arrays(users, items, np.ones_like(vals), 64, 40)
    k = 5
    u_idx, u_val, u_mask = padded_uniform(r, 'user', 8)
    i_idx, i_val, i_mask = padded_uniform(r, 'item', 8)
    P = jnp.full((u_idx.shape[0], k), 0.1, jnp.float32)
    Q = jnp.full((i_idx.shape[0], k), 0.1, jnp.float32)
    epoch = make_sharded_als_epoch(mesh8, c_pos=1.0, reg=0.015)
    P1, Q1 = epoch(P, Q, *(jnp.asarray(x) for x in
                           (u_idx, u_val, u_mask, i_idx, i_val, i_mask)))

    # single-device reference: the ops.als path
    from mfrec_tpu.ops import als as als_ops
    P2 = jnp.full((64, k), 0.1, jnp.float32)
    Q2 = jnp.full((40, k), 0.1, jnp.float32)
    P2, Q2 = als_ops.als_wrmf_train(P2, Q2, r.padded_rows(axis='user'),
                                    r.padded_rows(axis='item'),
                                    nbr_epochs=1, c_pos=1.0, reg=0.015)
    P2f, Q2f = np.asarray(P2), np.asarray(Q2)
    P1f, Q1f = np.asarray(P1)[:64], np.asarray(Q1)[:40]
    active_u = r.user_counts() > 0
    active_i = r.item_counts() > 0
    np.testing.assert_allclose(P1f[active_u], P2f[active_u], atol=1e-2,
                               rtol=1e-1)
    np.testing.assert_allclose(Q1f[active_i], Q2f[active_i], atol=1e-2,
                               rtol=1e-1)


def test_gd_model_dsgd_engine(mesh8, small_dataset):
    '''GDRecommender with engine='dsgd' trains over the 8-device mesh.'''
    from mfrec_tpu.models.gd import GDRecommender
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = GDRecommender(U, I, {'min_epochs': 10, 'max_epochs': 10,
                             'nbr_features': 6, 'learning_rate': 0.01,
                             'regularization_model': 0.02,
                             'engine': 'dsgd'})
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)
    assert m.P.shape == (U, 6)
    hist = m.get_rmse_history()
    assert hist[-1] < hist[0]
    assert np.isfinite(m.predict_rating_with_bias(1, 1))


def test_sharded_alternating_trains(mesh8):
    '''The flagship alternating engine over an 8-device mesh: sharded
    half-passes + per-epoch all_gathers; must converge like the
    single-chip version.'''
    from mfrec_tpu.ops import sgd_mf
    from mfrec_tpu.parallel import alternating_sharded as alt
    users, items, vals = synthetic_ratings(240, 160, 5000, rank=5, seed=21)
    U, I = 240, 160
    D = 8
    p_layout, q_layout, (Ushard, Ishard, W) = \
        alt.build_sharded_alternating_layout(users, items, vals, D, U, I,
                                             batch_size=512, max_window=64)
    st = sgd_mf.init_state(U, I, 6, feature_init=0.1, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(np.asarray(st.P), np.asarray(st.Q),
                                        np.asarray(st.bu), np.asarray(st.bi))
    Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
    Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
    mu = jnp.float32(vals.mean())
    epoch = alt.make_sharded_alternating_epoch(mesh8, W, lr=0.2, K=0.02,
                                               bias_mode='fixed', chunk=512)
    pl = tuple(jnp.asarray(x) for x in p_layout)
    ql = tuple(jnp.asarray(x) for x in q_layout)
    hist = []
    for _ in range(25):
        Paug, Qaug, rmse = epoch(Paug, Qaug, mu, *pl, *ql)
        hist.append(float(rmse))
    assert hist[-1] < hist[0] - 0.04
    P = alt.unpad_factors_sharded(np.asarray(Paug), Ushard, W, D, U)
    Q = alt.unpad_factors_sharded(np.asarray(Qaug), Ishard, W, D, I)
    assert np.isfinite(P).all() and np.isfinite(Q).all()
    # Parity vs the single-device alternating epoch on the same data and
    # the same symmetry-broken init — the assertion that actually catches
    # row/column-mixing sharding bugs (with constant init every row was
    # identical and any permutation passed).
    spl = sgd_mf.sorted_pass_layout(users, items, vals, 512, axis='user',
                                    max_window=64)
    sql = sgd_mf.sorted_pass_layout(users, items, vals, 512, axis='item',
                                    max_window=64)
    W_u1, W_i1 = spl[-1], sql[-1]
    Pa1 = jnp.asarray(np.pad(
        sgd_mf.augment_factors(np.asarray(st.P), np.asarray(st.Q),
                               np.asarray(st.bu), np.asarray(st.bi))[0],
        ((0, W_u1), (0, 0))))
    Qa1 = jnp.asarray(np.pad(
        sgd_mf.augment_factors(np.asarray(st.P), np.asarray(st.Q),
                               np.asarray(st.bu), np.asarray(st.bi))[1],
        ((0, W_i1), (0, 0))))
    ep1 = sgd_mf.make_alternating_epoch(W_u1, W_i1, 0.2, 0.02,
                                        bias_mode='fixed', chunk=512,
                                        donate=False)
    p1 = tuple(jnp.asarray(x) for x in spl[:-1])
    q1 = tuple(jnp.asarray(x) for x in sql[:-1])
    r1 = None
    for _ in range(25):
        Pa1, Qa1, r1 = ep1(Pa1, Qa1, mu, p1, q1)
    assert abs(hist[-1] - float(r1)) < 0.02, (hist[-1], float(r1))
    # prediction sanity on training pairs
    pred = float(mu) + (P[users[:200], :6] * Q[items[:200], :6]).sum(-1)
    rmse_manual = np.sqrt(((vals[:200] - np.clip(pred, 1, 5)) ** 2).mean())
    assert rmse_manual < hist[0]


def test_sharded_alternating_layout_covers_all():
    from mfrec_tpu.parallel import alternating_sharded as alt
    users, items, vals = synthetic_ratings(100, 80, 1200, seed=22)
    p_layout, q_layout, (Ushard, Ishard, W) = \
        alt.build_sharded_alternating_layout(users, items, vals, 4, 100, 80,
                                             batch_size=256, max_window=32)
    kl, og, rb, mb, lo = p_layout
    assert int(mb.sum()) == users.shape[0]
    assert kl.max() < W
    # reconstruct user ids: shard-local base + kl + shard offset
    got = []
    for d in range(4):
        for b in range(kl.shape[1]):
            sel = mb[d, b] > 0
            got.extend((kl[d, b][sel] + lo[d, b] + d * Ushard).tolist())
    assert sorted(got) == sorted(users.tolist())
