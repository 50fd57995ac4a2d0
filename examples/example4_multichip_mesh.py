'''
Multi-device training + serving on a device mesh.

Runs the two mesh engines through the public model API — the all_gather
sharded alternating engine and the ring-rotation engine (ppermute shard
rotation, no factor replica) — then mesh-sharded top-N serving, over
every visible device.  It needs at least two devices and says so, exiting
non-zero, when there are fewer.  On a GPU host it runs on the cards; on a
CPU-only machine give it a virtual mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/example4_multichip_mesh.py
'''
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MIN_DEVICES = 2


def main():
    import jax
    from mfrec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    n = len(jax.devices())
    if n < MIN_DEVICES:
        print('this example needs >= %d devices, found %d (%s); on a CPU '
              'host set XLA_FLAGS=--xla_force_host_platform_device_count=8'
              % (MIN_DEVICES, n, jax.devices()[0].platform),
              file=sys.stderr)
        return 1
    print('mesh over %d %s devices' % (n, jax.devices()[0].platform))

    import numpy as np
    from mfrec_tpu.data.movielens import synthetic_ratings, train_test_split
    from mfrec_tpu.eval.metrics import test_predict_rating
    from mfrec_tpu.models.gd import GDRecommender

    U, I = 2000, 1200
    users, items, vals = synthetic_ratings(U, I, 60_000, rank=6, seed=3)
    (tu, ti, tv), u_test = train_test_split(users, items, vals,
                                            test_fraction=0.2)

    for engine in ('alternating_sharded', 'alternating_ring'):
        model = GDRecommender(U, I, {
            'engine': engine, 'nbr_features': 16,
            'learning_rate': 0.15, 'regularization_model': 0.02,
            'min_epochs': 30, 'max_epochs': 30, 'batch_size': 4096,
            'inner_steps': 2})
        model.set_ratings(tu, ti, tv)
        model.train(handle_bias=True)
        hist = model.get_rmse_history()
        rmse = test_predict_rating(model, u_test, 5000,
                                   predictor='predict_rating_with_bias',
                                   quiet=True)[0]
        print('%-22s train rmse %.4f -> %.4f | test rmse %.4f'
              % (engine, hist[0], hist[-1], rmse))

        # mesh-sharded top-N serving (items axis sharded + re-rank):
        # recommend_batch auto-selects the sharded path when >1 device
        ids, scores = model.recommend_batch(
            np.arange(8), nbr_recommendations=5)
        print('  top-5 for user 0:', ids[0].tolist())
    return 0


if __name__ == '__main__':
    sys.exit(main())
