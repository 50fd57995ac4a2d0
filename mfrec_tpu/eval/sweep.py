'''
Hyperparameter sweeps.

Re-design of reference ``mfrec/recommendation/metaparameters.py`` (dev
sketches referencing undefined globals) as working utilities: each sweep
builds/evaluates models over a parameter grid and returns (values, scores).
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu.eval.metrics import test_predict_rating, precision_recall


def sweep_parameter(factory, train_kwargs, u_test, name, values,
                    metric='rmse', predictor='predict_rating',
                    nbr_samples=5000, nbr_recommendations=5):
    '''Train a fresh model per value of parameter `name`; score on u_test.

    factory(params_dict) -> untrained model.  Returns (values, scores).
    '''
    scores = np.zeros(len(values))
    for j, val in enumerate(values):
        model = factory({name: val})
        model.train(**(train_kwargs or {}))
        if metric == 'rmse':
            scores[j] = test_predict_rating(model, u_test, nbr_samples,
                                            predictor=predictor,
                                            quiet=True)[0]
        else:
            scores[j] = precision_recall(model, u_test,
                                         nbr_recommendations)[0]
    return np.asarray(values), scores


def optimize_k(model, u_test, ks=range(5, 55, 5), nbr_samples=2000,
               predictor='predict', retrain=False):
    '''Sweep the kNN neighborhood size (reference metaparameters.py:1-7)
    on an already-trained model: sets ``model.k`` per value before
    scoring (k is a prediction-time parameter for the kNN predictors).
    For models whose train() precomputes k-sized neighbor caches
    (KNNUsersRecommender), pass ``retrain=True``.'''
    k0 = model.k
    k_min = int(getattr(model, 'k_min', 1))
    # k below k_min can never form a usable neighborhood — skip those
    # points explicitly instead of scoring them to NaN (and tripping
    # numpy empty-slice warnings inside the predictors)
    ks = [int(k) for k in ks if int(k) >= k_min]
    scores = []
    for k in ks:
        model.k = int(k)
        if retrain:
            model.train(k=int(k))
        rmse = test_predict_rating(
            model, u_test, nbr_samples, predictor=predictor, quiet=True)[0]
        scores.append(rmse)
    model.k = k0
    return np.asarray(ks), np.asarray(scores)


def optimize_similarity_threshold(factory, train_kwargs, u_test,
                                  thresholds=None, nbr_samples=2000,
                                  predictor='predict'):
    '''Sweep the similarity threshold (reference metaparameters.py:9-17).
    The threshold only affects prediction, so the model is trained ONCE
    and re-scored per threshold (the reference sketch retrains per point).'''
    if thresholds is None:
        thresholds = np.linspace(0.0, 0.99, 20)
    model = factory({})
    model.train(**(train_kwargs or {}))
    scores = []
    for t in thresholds:
        model.sim_threshold = float(t)
        scores.append(test_predict_rating(model, u_test, nbr_samples,
                                          predictor=predictor, quiet=True)[0])
    return np.asarray(list(thresholds)), np.asarray(scores)


def optimize_dim(factory, train_kwargs, u_test, dims=range(10, 50, 2),
                 nbr_samples=1000):
    '''reference metaparameters.py:19-29.'''
    return sweep_parameter(factory, train_kwargs, u_test, 'nbr_features',
                           list(dims), nbr_samples=nbr_samples,
                           predictor='predict')


def optimize_regularization_vmapped(users, items, values, u_test, regs,
                                    rank=16, epochs=30, lr=0.01,
                                    batch_size=8192, feature_init=0.1,
                                    seed=0):
    '''Train one model PER regularization value simultaneously — factors
    stacked on a sweep axis, the whole sweep is a single vmapped device
    program (batched replacement for the reference's sequential
    re-train loops; the ALS L2 "reg sweep" of BASELINE config 2 for the
    SGD path).  Returns (regs, test_rmses [S]).'''
    import jax.numpy as jnp
    from mfrec_tpu.ops import sgd_mf
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    values = np.asarray(values, np.float32)
    U, I = int(users.max()) + 1, int(items.max()) + 1
    S = len(regs)
    mu = float(values.mean())
    # fixed BellKor-free biases: simple deviations (cheap, shared)
    cnt_i = np.bincount(items, minlength=I)
    bi = np.where(cnt_i > 0,
                  np.bincount(items, weights=values - mu, minlength=I)
                  / np.maximum(cnt_i, 1), 0.0).astype(np.float32)
    resid = values - mu - bi[items]
    cnt_u = np.bincount(users, minlength=U)
    bu = np.where(cnt_u > 0,
                  np.bincount(users, weights=resid, minlength=U)
                  / np.maximum(cnt_u, 1), 0.0).astype(np.float32)

    # seed controls the batch shuffle AND the init draw below, so callers
    # varying it for variance estimation get genuinely independent runs
    # (a hardcoded shuffle seed made 'seeds' share batches)
    ub, ib, rb, mb = sgd_mf.batch_ratings(users, items, values, batch_size,
                                          seed=int(seed))
    # One random init SHARED across the sweep axis: the per-sample epoch
    # trains all features jointly, and a constant fill is a fixed point
    # of the column symmetry (rank-1 collapse — see
    # tests/test_init_symmetry.py); identical draws per candidate keep
    # the regularization comparison init-controlled.
    rng = np.random.default_rng(seed)
    P0 = rng.normal(0.0, abs(float(feature_init)),
                    (U, rank)).astype(np.float32)
    Q0 = rng.normal(0.0, abs(float(feature_init)),
                    (I, rank)).astype(np.float32)
    Ps = jnp.tile(jnp.asarray(P0)[None], (S, 1, 1))
    Qs = jnp.tile(jnp.asarray(Q0)[None], (S, 1, 1))
    Ks = jnp.asarray(np.asarray(regs, np.float32))
    epoch = sgd_mf.make_multi_reg_epoch(lr, bias_mode='fixed')
    args = tuple(jnp.asarray(x) for x in (ub, ib, rb, mb))
    for _ in range(int(epochs)):
        Ps, Qs, rmses = epoch(Ps, Qs, Ks, jnp.asarray(bu), jnp.asarray(bi),
                              jnp.float32(mu), *args)
    # vectorized held-out eval for every model at once
    test = np.asarray(u_test)
    tu = test[:, 0].astype(int)
    ti = test[:, 1].astype(int)
    tv = test[:, 2]
    Psn, Qsn = np.asarray(Ps), np.asarray(Qs)
    pred = mu + bu[tu][None, :] + bi[ti][None, :] \
        + np.einsum('snk,snk->sn', Psn[:, tu], Qsn[:, ti])
    rmses = np.sqrt(((tv[None, :] - pred) ** 2).mean(axis=1))
    return np.asarray(regs), rmses
