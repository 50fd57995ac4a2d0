'''Ring-rotation alternating engine (parallel.ring_alternating): the
all_gather-free flagship variant — read-side shards rotate via ppermute.
Parity with the all_gather engine is RMSE-level (the within-device update
order changes), the standard contract for order-changing parallel tiers.'''
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfrec_tpu.parallel.mesh import make_mesh
from mfrec_tpu.data.movielens import synthetic_ratings


@pytest.fixture(scope='module')
def mesh8():
    assert len(jax.devices()) >= 8, 'conftest must provide 8 CPU devices'
    return make_mesh(8)


def test_ring_layout_covers_all_rounds():
    '''Every rating lands in exactly one (device, round) bucket, with the
    round matching the ring schedule: rating (u, i) is processed on
    u's device d at round s = (shard(i) - d) mod D, with read-shard-local
    item ids.'''
    from mfrec_tpu.parallel import ring_alternating as ring
    users, items, vals = synthetic_ratings(100, 80, 1200, seed=22)
    D = 4
    p_layout, q_layout, (Ushard, Ishard, W) = \
        ring.build_ring_alternating_layout(users, items, vals, D, 100, 80,
                                           batch_size=256, max_window=32)
    kl, og, rb, mb, lo = p_layout
    assert int(mb.sum()) == users.shape[0]
    assert kl.max() < W
    got = []
    for d in range(D):
        for s in range(D):
            c = (d + s) % D
            for b in range(kl.shape[2]):
                sel = mb[d, s, b] > 0
                u = kl[d, s, b][sel] + lo[d, s, b] + d * Ushard
                i = og[d, s, b][sel] + c * Ishard
                got.extend(zip(u.tolist(), i.tolist(), rb[d, s, b][sel]))
    want = sorted(zip(users.tolist(), items.tolist(), vals.tolist()))
    assert sorted(got) == want


def test_ring_alternating_trains(mesh8):
    '''Ring epochs converge like the all_gather engine on the same data
    (same mesh, same hyperparameters, RMSE-level agreement).'''
    from mfrec_tpu.ops import sgd_mf
    from mfrec_tpu.parallel import alternating_sharded as alt
    from mfrec_tpu.parallel import ring_alternating as ring
    users, items, vals = synthetic_ratings(240, 160, 5000, rank=5, seed=21)
    U, I = 240, 160
    D = 8
    st = sgd_mf.init_state(U, I, 6, feature_init=0.1, mode='normal')
    Paug0, Qaug0 = sgd_mf.augment_factors(
        np.asarray(st.P), np.asarray(st.Q),
        np.asarray(st.bu), np.asarray(st.bi))
    mu = jnp.float32(vals.mean())

    def run(builder, factory):
        p_layout, q_layout, (Ushard, Ishard, W) = builder(
            users, items, vals, D, U, I, batch_size=512, max_window=64)
        Paug = jnp.asarray(alt.pad_factors_sharded(Paug0, Ushard, W, D))
        Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug0, Ishard, W, D))
        epoch = factory(mesh8, W, lr=0.2, K=0.02, bias_mode='fixed',
                        chunk=512)
        pl = tuple(jnp.asarray(x) for x in p_layout)
        ql = tuple(jnp.asarray(x) for x in q_layout)
        hist = []
        for _ in range(25):
            Paug, Qaug, rmse = epoch(Paug, Qaug, mu, *pl, *ql)
            hist.append(float(rmse))
        P = alt.unpad_factors_sharded(np.asarray(Paug), Ushard, W, D, U)
        Q = alt.unpad_factors_sharded(np.asarray(Qaug), Ishard, W, D, I)
        return hist, P, Q

    hist_r, P_r, Q_r = run(ring.build_ring_alternating_layout,
                           ring.make_ring_alternating_epoch)
    hist_g, P_g, Q_g = run(alt.build_sharded_alternating_layout,
                           alt.make_sharded_alternating_epoch)
    assert np.isfinite(P_r).all() and np.isfinite(Q_r).all()
    assert hist_r[-1] < hist_r[0] - 0.05
    # Both engines must converge.  They do NOT share a trajectory under
    # symmetry-broken init (the old <0.02 agreement here was an artifact
    # of the constant-init rank-1 collapse): ring's D
    # conflict-free rotation rounds see progressively fresher factors
    # WITHIN an epoch, so it converges at least as fast per epoch as the
    # all_gather engine, whose half-passes read a stale full replica.
    assert hist_g[-1] < hist_g[0] - 0.02
    assert hist_r[-1] <= hist_g[-1] + 0.02, (hist_r[-1], hist_g[-1])


def test_ring_alternating_deterministic(mesh8):
    from mfrec_tpu.ops import sgd_mf
    from mfrec_tpu.parallel import alternating_sharded as alt
    from mfrec_tpu.parallel import ring_alternating as ring
    users, items, vals = synthetic_ratings(120, 90, 2000, seed=5)
    U, I, D = 120, 90, 8
    p_layout, q_layout, (Ushard, Ishard, W) = \
        ring.build_ring_alternating_layout(users, items, vals, D, U, I,
                                           batch_size=256, max_window=32)
    st = sgd_mf.init_state(U, I, 4, feature_init=0.1, mode='normal')
    Paug, Qaug = sgd_mf.augment_factors(np.asarray(st.P), np.asarray(st.Q),
                                        np.asarray(st.bu), np.asarray(st.bi))
    Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
    Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
    epoch = ring.make_ring_alternating_epoch(mesh8, W, lr=0.1, K=0.02,
                                             chunk=256)
    pl = tuple(jnp.asarray(x) for x in p_layout)
    ql = tuple(jnp.asarray(x) for x in q_layout)
    mu = jnp.float32(vals.mean())
    P1, Q1, r1 = epoch(Paug, Qaug, mu, *pl, *ql)
    P2, Q2, r2 = epoch(Paug, Qaug, mu, *pl, *ql)
    assert float(r1) == float(r2)
    assert np.array_equal(np.asarray(P1), np.asarray(P2))


def test_gd_model_ring_engine(mesh8):
    '''engine='alternating_ring' through the public model API.'''
    from mfrec_tpu.models.gd import GDRecommender
    users, items, vals = synthetic_ratings(160, 120, 4000, rank=4, seed=7)
    m = GDRecommender(160, 120, {
        'engine': 'alternating_ring', 'nbr_features': 6,
        'learning_rate': 0.2, 'regularization_model': 0.02,
        'min_epochs': 15, 'max_epochs': 15, 'batch_size': 512,
        # aggressive lr on tiny 512-batches: the shipped inner_steps
        # default (tuned for lr 0.15 / batch 16k) over-iterates each
        # window here — pin the sweep count like the other engine tests
        'inner_steps': 8})
    m.set_ratings(users, items, vals)
    m.train(handle_bias=True)
    assert np.isfinite(m.P).all() and np.isfinite(m.Q).all()
    hist = m.get_rmse_history()
    assert hist[-1] < hist[0]
