'''
FNRecommender — the Koren KDD'08 factorized item-item neighborhood model,
implemented for real.

The reference ``mfrec/recommendation/fn.py:19-96`` declares this model
(docstring cites Koren, "Factorization Meets the Neighborhood") but never
delivers it: ``train`` eval-dispatches to never-imported KMF kernels and
``predict`` is ``pass`` (SURVEY.md §2.6).  Here the declared model is
built: learned item-item weights w_ij = q_i.x_j (explicit) and implicit
offsets c_ij = q_i.y_j over each user's rated set,

    r_hat(u,i) = mu + b_u + b_i
               + q_i . |R(u)|^-1/2 sum_{j in R(u)} [(r_uj - b_uj) x_j + y_j]

trained by mini-batch SGD on device (``ops.fn.make_fn_epoch``), with a
strictly-sequential numpy oracle (``ops.reference_numpy.fn_train_oracle``)
as the parity spec.

Parameter names follow the reference's FN PARAMETERS_INDEX (fn.py:28-37).
Note the reference maps ``regularization_users/items/bias`` onto attributes
``K/K2/K3`` while its __init__ sets ``K_users/K_items/K_bias`` — so
set_parameters there writes attributes train() never reads (latent defect).
Here the mapping is coherent: ``regularization_users`` -> K_users
(regularizes the implicit y factors — the user-profile side),
``regularization_items`` -> K_items (regularizes q and x), and
``regularization_bias`` -> K_bias (both learned biases).

After ``train()`` the per-user aggregate profiles a_u are materialized
into ``self.P``, so every MFRecommender serving kernel (fused top-N,
batched prediction, factor-space similarity) works on an FN model
unchanged: prediction is exactly mu + b_u + b_i + P[u].Q[i].
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.base import DefaultRate, Error
from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.ops import fn as fn_ops
from mfrec_tpu.ops import sgd_mf
from mfrec_tpu.engine.trainer import ConvergenceDriver


class FNRecommender(MFRecommender):
    '''Factorized Neighborhood Recommendation Engine (Koren KDD'08 §4).'''

    PARAMETERS_INDEX = {'nbr_epochs': 'nbr_epochs',
                        'min_improvement': 'min_improvement',
                        'feature_init': 'feature_init',
                        'learning_rate': 'learning_rate',
                        'learning_rate_users': 'learning_rate_users',
                        'learning_rate_items': 'learning_rate_items',
                        'regularization_users': 'K_users',
                        'regularization_items': 'K_items',
                        'regularization_bias': 'K_bias',
                        'nbr_features': 'dimensionality',
                        'batch_size': 'batch_size',
                        'engine': 'engine',
                        'inner_steps': 'inner_steps'}

    _default_predictor_mode = 'bias'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False):
        MFRecommender.__init__(self, nbr_users, nbr_items, None)

        # Reference FN defaults (fn.py:44-53).  The rates are DefaultRate
        # sentinels (numerically the reference 0.01, distinguishable from
        # a user assigning 0.01): the alternating engine applies row-MEAN
        # window steps and substitutes the benchmarked 0.15 when the user
        # has not chosen a rate — same contract as GDRecommender._alt_lrs.
        self.nbr_epochs = 200
        self.min_improvement = 0.0001
        self.feature_init = 0.1
        self.learning_rate = DefaultRate(0.01)
        self.learning_rate_users = DefaultRate(0.01)
        self.learning_rate_items = DefaultRate(0.01)
        self.K_users = 0.1
        self.K_items = 0.1
        self.K_bias = 0.007
        self.dimensionality = 40
        self.batch_size = 16384
        # 'auto' = the sorted-window alternating tier (the benchmarked
        # fast path); 'fused' keeps the per-batch
        # scatter-add tier (the oracle-parity tier) reachable.
        self.engine = 'auto'
        # gradient sweeps per window batch on the alternating tier;
        # profile/X/Y aggregation phases stay once-per-epoch like the
        # implicit tier's Y machinery.  FN's per-epoch quality driver is
        # the once-per-epoch X/Y update, not the half-pass sweeps, so
        # more sweeps per batch stop paying off early; T=64 is the
        # default.
        self.inner_steps = 64

        if parameters:
            self.set_parameters(parameters)

        self.rmse_history = []
        self.X = None                 # explicit-weight item factors
        self.Y = None                 # implicit-offset item factors

    def __repr__(self):
        return ('Factorized Neighborhood Recommendation Engine\n'
                'Number of users: %d\nNumber of items: %d\n'
                % (self.nbr_users, self.nbr_items))

    # ------------------------------------------------------------- training
    def train(self, initialize_model=True, verbose=False):
        '''Train the factorized-neighborhood objective.

        engine='auto' (default) runs the sorted-window alternating tier
        (``ops.fn.make_fn_alternating_epoch`` — the benchmarked fast
        path); 'fused' the per-batch scatter-add tier (the oracle-parity
        tier).  K regularization note: q and x are regularized by
        K_items, y by K_users (see module docstring for the
        reference-defect mapping).
        '''
        engine = self.engine
        if engine == 'auto':
            import jax
            engine = ('alternating_sharded' if len(jax.devices()) > 1
                      else 'alternating')
        if engine == 'alternating':
            self._train_alternating(initialize_model, verbose)
        elif engine == 'alternating_sharded':
            self._train_alternating_sharded(initialize_model, verbose)
        elif engine == 'fused':
            self._train_fused(initialize_model, verbose)
        else:
            raise Error('unknown engine %r' % (self.engine,))

    def _fn_lrs(self, default):
        '''Engine rates: any plain-float assignment (even of the
        reference default 0.01) counts as a user choice; unset rates get
        the row-mean 0.15 on the alternating tier and the reference 0.01
        on the fused tier (per-sample semantics).'''
        def val(attr):
            v = getattr(self, attr)
            return default if isinstance(v, DefaultRate) else float(v)
        return (val('learning_rate'), val('learning_rate_users'),
                val('learning_rate_items'))

    def _init_or_resume(self, initialize_model):
        k = self.dimensionality
        if initialize_model or self.Q is None or self.X is None:
            return fn_ops.init_fn_state(
                self.nbr_users, self.nbr_items, k,
                feature_init=self.feature_init,
                seed=int(self.rng.integers(2 ** 31)),
                mu=self.overall_bias or 0.0)
        return fn_ops.FNState(
            Q=jnp.asarray(self.Q, jnp.float32),
            X=jnp.asarray(self.X, jnp.float32),
            Y=jnp.asarray(self.Y, jnp.float32),
            bu=jnp.asarray(self.users_bias, jnp.float32),
            bi=jnp.asarray(self.items_bias, jnp.float32),
            mu=jnp.float32(self.overall_bias or 0.0))

    def _materialize(self, state):
        '''Post-train: materialize user profiles a_u into self.P so every
        MF serving kernel works on an FN model unchanged.'''
        fl, fv, fm = fn_ops.padded_user_lists(self.ratings)
        profiles = fn_ops.user_aggregates(
            state, jnp.asarray(fl), jnp.asarray(fv), jnp.asarray(fm))
        self.P = np.array(profiles)
        self.Q = np.array(state.Q)
        self.X = np.array(state.X)
        self.Y = np.array(state.Y)
        self.users_bias = np.array(state.bu)
        self.items_bias = np.array(state.bi)

    def _train_fused(self, initialize_model=True, verbose=False):
        '''Per-batch scatter-add tier (``ops.fn.make_fn_epoch``).'''
        uidx, iidx, vals = self.ratings.shuffled(
            int(self.rng.integers(2 ** 31)))
        self.compute_overall_avg()
        state = self._init_or_resume(initialize_model)
        fl, fv, fm = fn_ops.padded_user_lists(self.ratings)
        fl, fv, fm = jnp.asarray(fl), jnp.asarray(fv), jnp.asarray(fm)
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size)
        ub, ib = jnp.asarray(ub), jnp.asarray(ib)
        rb, mb = jnp.asarray(rb), jnp.asarray(mb)
        lr, lr_bu, lr_bi = self._fn_lrs(0.01)   # reference per-sample rates
        epoch = fn_ops.make_fn_epoch(
            lr, lr_bu, lr_bi, self.K_items,
            self.K_bias, self.K_bias, K_y=self.K_users,
            lo=self.min_rating, hi=self.max_rating)
        driver = ConvergenceDriver(1, self.nbr_epochs, self.min_improvement)
        state = driver.run(
            lambda s: epoch(s, ub, ib, rb, mb, fl, fv, fm), state)
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        self._materialize(state)

    def _train_alternating(self, initialize_model=True, verbose=False):
        '''Sorted-window alternating tier
        (``ops.fn.make_fn_alternating_epoch``): profile aggregation,
        both half-passes and the X/Y steps are all scatter-free window
        work (the half-passes run the Pallas kernel on a GPU).'''
        self.compute_overall_avg()
        k = self.dimensionality
        st = self._init_or_resume(initialize_model)
        # NOT the plain GD tier's W=128: like the SVD++ tier, the
        # profile-aggregation phases couple rows across the batch —
        # share the implicit tier's W=512 layout default
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(512)
        lr, lr_bu, lr_bi = self._fn_lrs(0.15)   # row-mean window steps
        Paug, Qaug = sgd_mf.augment_factors(
            jnp.zeros((self.nbr_users + W_user, k), jnp.float32),
            jnp.pad(st.Q, ((0, W_item), (0, 0))),
            jnp.pad(st.bu, (0, W_user)),
            jnp.pad(st.bi, (0, W_item)))
        Xpad = jnp.pad(st.X, ((0, W_item), (0, 0)))
        Ypad = jnp.pad(st.Y, ((0, W_item), (0, 0)))
        counts = self.ratings.user_counts().astype(np.float32)
        nrm = np.zeros(self.nbr_users + W_user, np.float32)
        nrm[:self.nbr_users] = np.where(
            counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1.0)), 0.0)
        nrm_rows = jnp.asarray(nrm)
        mu = jnp.float32(self.overall_bias or 0.0)
        epoch = fn_ops.make_fn_alternating_epoch(
            W_user, W_item, lr, lr_bu, lr_bi, lr,
            K=self.K_items, K_bu=self.K_bias, K_bi=self.K_bias,
            K_x=self.K_items, K_y=self.K_users,
            lo=self.min_rating, hi=self.max_rating,
            chunk=min(8192, self.batch_size),
            inner_steps=self.inner_steps)
        driver = ConvergenceDriver(1, self.nbr_epochs, self.min_improvement)

        def one_epoch(s):
            Pa, Qa, Xp, Yp = s
            Pa, Qa, Xp, Yp, rmse = epoch(Pa, Qa, Xp, Yp, mu, p_layout,
                                         q_layout, nrm_rows)
            return (Pa, Qa, Xp, Yp), rmse

        Paug, Qaug, Xpad, Ypad = driver.run(one_epoch,
                                            (Paug, Qaug, Xpad, Ypad))
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        final = fn_ops.FNState(
            Q=Qaug[:self.nbr_items, :k],
            X=Xpad[:self.nbr_items],
            Y=Ypad[:self.nbr_items],
            bu=Paug[:self.nbr_users, k],
            bi=Qaug[:self.nbr_items, k + 1],
            mu=mu)
        self._materialize(final)

    def _train_alternating_sharded(self, initialize_model=True,
                                   verbose=False, n_devices=None):
        '''FN over the device mesh (``parallel.fn_sharded``): the six
        windowed phases of the single-chip tier, users/items
        range-partitioned like the other sharded engines, 5
        all_gathers per epoch (X, Y, Q, P, G+bu).  BEYOND the reference
        (it never implements FN at all).'''
        import jax
        from mfrec_tpu.parallel import alternating_sharded as alt
        from mfrec_tpu.parallel import fn_sharded as fns
        from mfrec_tpu.parallel.mesh import make_mesh
        self.compute_overall_avg()
        k = self.dimensionality
        st = self._init_or_resume(initialize_model)
        D = n_devices or len(jax.devices())
        mesh = make_mesh(D)
        uidx, iidx, vals = self.ratings.coo()
        max_window = min(512, max(self.nbr_users, self.nbr_items))
        p_layout, q_layout, (Ushard, Ishard, W) = \
            alt.build_sharded_alternating_layout(
                uidx, iidx, vals, D, self.nbr_users, self.nbr_items,
                batch_size=self.batch_size, max_window=max_window)
        lr, lr_bu, lr_bi = self._fn_lrs(0.15)
        Paug, Qaug = sgd_mf.augment_factors(
            np.zeros((self.nbr_users, k), np.float32),
            np.array(st.Q), np.array(st.bu), np.array(st.bi))
        Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
        Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
        Xpad = jnp.asarray(alt.pad_factors_sharded(
            np.array(st.X), Ishard, W, D))
        Ypad = jnp.asarray(alt.pad_factors_sharded(
            np.array(st.Y), Ishard, W, D))
        counts = self.ratings.user_counts().astype(np.float32)
        nrm_host = np.where(counts > 0,
                            1.0 / np.sqrt(np.maximum(counts, 1.0)),
                            0.0).astype(np.float32)
        nrm = jnp.asarray(alt.pad_factors_sharded(
            nrm_host[:, None], Ushard, W, D)[:, 0])
        mu = jnp.float32(self.overall_bias or 0.0)
        epoch = fns.make_sharded_fn_epoch(
            mesh, W, lr=lr, lr_bu=lr_bu, lr_bi=lr_bi, lr_xy=lr,
            K=self.K_items, K_bu=self.K_bias, K_bi=self.K_bias,
            K_x=self.K_items, K_y=self.K_users,
            lo_r=self.min_rating, hi_r=self.max_rating,
            chunk=min(8192, self.batch_size),
            inner_steps=self.inner_steps)
        p_dev = tuple(jnp.asarray(x) for x in p_layout)
        q_dev = tuple(jnp.asarray(x) for x in q_layout)
        driver = ConvergenceDriver(1, self.nbr_epochs,
                                   self.min_improvement)

        def one_epoch(s):
            Pa, Qa, Xp, Yp = s
            Pa, Qa, Xp, Yp, rmse = epoch(Pa, Qa, Xp, Yp, mu, nrm,
                                         *p_dev, *q_dev)
            return (Pa, Qa, Xp, Yp), rmse

        Paug, Qaug, Xpad, Ypad = driver.run(one_epoch,
                                            (Paug, Qaug, Xpad, Ypad))
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        Pa = alt.unpad_factors_sharded(np.asarray(Paug), Ushard, W, D,
                                       self.nbr_users)
        Qa = alt.unpad_factors_sharded(np.asarray(Qaug), Ishard, W, D,
                                       self.nbr_items)
        final = fn_ops.FNState(
            Q=jnp.asarray(Qa[:, :k]),
            X=jnp.asarray(alt.unpad_factors_sharded(
                np.asarray(Xpad), Ishard, W, D, self.nbr_items)),
            Y=jnp.asarray(alt.unpad_factors_sharded(
                np.asarray(Ypad), Ishard, W, D, self.nbr_items)),
            bu=jnp.asarray(Pa[:, k]),
            bi=jnp.asarray(Qa[:, k + 1]),
            mu=mu)
        self._materialize(final)

    def get_rmse_history(self):
        return np.asarray(self.rmse_history)

    def _extra_state_arrays(self):
        '''Persist the explicit-weight factors X (P holds derived
        profiles and is checkpointed as svd_v; Y rides items_feedback) so
        fold-in keeps working after load.'''
        return {} if self.X is None else {'X': self.X}

    # ----------------------------------------------------------- prediction
    def predict_rating_with_bias(self, item_index, user_index):
        '''mu + b_u + b_i + q_i . a_u (profile a_u precomputed at train).'''
        return float(self.clamping(
            self.overall_bias + self.users_bias[user_index]
            + self.items_bias[item_index]
            + self.Q[item_index] @ self.P[user_index],
            self.min_rating, self.max_rating))

    predict = predict_rating_with_bias
    predict_rating = predict_rating_with_bias

    def refresh_user_profile(self, user_index):
        '''Recompute one user's aggregate a_u from the current ratings —
        the FN fold-in: new ratings change the profile with NO retraining
        (the neighborhood model's operational advantage, Koren §4).'''
        ptr, items, vals = self.ratings.csr()
        s, e = int(ptr[user_index]), int(ptr[user_index + 1])
        ids = items[s:e]
        if ids.size == 0:
            self.P[user_index] = 0.0
            return
        resid = vals[s:e] - (self.overall_bias
                             + self.users_bias[user_index]
                             + self.items_bias[ids])
        nrm = 1.0 / np.sqrt(ids.size)
        self.P[user_index] = nrm * (resid @ self.X[ids]
                                    + self.Y[ids].sum(0))

    def add_user(self, user_label, users_ratings_index, users_ratings):
        '''Fold in a new user: append, store ratings, rebuild the profile
        — no gradient steps needed.'''
        new_id = self.users.add(user_label)
        self.ratings.grow(nbr_users=new_id + 1)
        self.ratings.set_many(
            np.full(len(users_ratings), new_id, np.int32),
            np.asarray(users_ratings_index, np.int32),
            np.asarray(users_ratings, np.float32))
        self.P = np.resize(self.P, (new_id + 1, self.dimensionality))
        self.users_bias = np.resize(self.users_bias, new_id + 1)
        self.users_bias[new_id] = 0.0
        self.refresh_user_profile(new_id)
        return new_id
