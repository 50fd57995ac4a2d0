'''
GDRecommender — Funk/BellKor SGD matrix factorization.

Re-design of reference ``mfrec/recommendation/gradient_descent.py:27-954``
plus its Cython inner loops (``gd_estimator.pyx``).  Training engines:

* ``engine='auto'`` (default): the benchmarked flagship per substrate —
  ``alternating`` on one device, ``alternating_sharded`` on a mesh.
* ``engine='alternating'``: the single-device flagship — scatter-free
  sorted-window half-passes (``inner_steps`` gradient sweeps per batch;
  a fused Pallas kernel on a GPU).
* ``engine='alternating_sharded'`` / ``'alternating_ring'``: the same
  engine over the device mesh (all_gather per factor side vs ppermute
  shard rotation); learned biases ride the sharded bias columns on
  ``alternating_sharded``.
* ``engine='fused'``: all-features mini-batch SGD epochs via
  ``ops.sgd_mf.make_fused_epoch`` — conflict-free scatter-add updates,
  one jitted scan per epoch, host-checked reference convergence rule.
* ``engine='dsgd'``: Gemulla ring DSGD (diagonal blocks over the mesh).
* ``engine='funk'``: the reference's feature-by-feature semantics (cached
  partial dot, trailing term, per-feature convergence, rating-cache
  freeze) via ``ops.sgd_mf.serial_feature_epoch`` — order-faithful, the
  exactness oracle and the fold-in retrain path; ``'funk_fused'`` runs
  the same schedule at mini-batch speed.

Public surface mirrors the reference: ``train``/``feature_training`` (+
``_bias``, ``_implicit``, ``_batch``, ``_online_prototype``, ``2``,
prototypes), predictors (plain/bias/implicit/by-label), fold-in
(``retrain_user``/``retrain_item``/``add_user``/``add_item``/
``folding_in_new_user``/``folding_in_new_item``), binary-cosine user
similarity, parameter names in ``PARAMETERS_INDEX``.
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.base import DefaultRate, Error
from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.ops import sgd_mf
from mfrec_tpu.ops import similarity as sim_ops
from mfrec_tpu.engine.trainer import ConvergenceDriver, ResilientDriver


class GDRecommender(MFRecommender):
    '''Gradient Descent based Recommendation Engine (regularized MF via SGD;
    Funk 2006 / Koren KDD'08 — see reference gradient_descent.py:27-56).'''

    PARAMETERS_INDEX = {'min_epochs': 'min_epochs',
                        'max_epochs': 'max_epochs',
                        'min_improvement': 'min_improvement',
                        'feature_init': 'feature_init',
                        'learning_rate': 'learning_rate',
                        'learning_rate_users': 'learning_rate_users',
                        'learning_rate_items': 'learning_rate_items',
                        'regularization_model': 'K',
                        'regularization_users_bias': 'K2',
                        'regularization_items_bias': 'K3',
                        'nbr_features': 'dimensionality',
                        'batch_size': 'batch_size',
                        'engine': 'engine',
                        'inner_steps': 'inner_steps',
                        'inner_steps_implicit': 'inner_steps_implicit',
                        'lr_decay': 'lr_decay',
                        'lr_plateau_decay': 'lr_plateau_decay',
                        'init_mode': 'init_mode',
                        'n_slices': 'n_slices',
                        'resilience': 'resilience',
                        'resilience_snapshot_every':
                            'resilience_snapshot_every',
                        'resilience_dir': 'resilience_dir'}

    _default_predictor_mode = 'dot_plus_one'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False):
        MFRecommender.__init__(self, nbr_users, nbr_items, None)

        # Reference defaults (gradient_descent.py:77-87).  The rates are
        # DefaultRate sentinels: numerically 0.001, but distinguishable
        # from a user assigning 0.001 — see _alt_lrs.
        self.min_epochs = 275
        self.max_epochs = 275
        self.min_improvement = 0.0001
        self.feature_init = 0.1
        self.learning_rate = DefaultRate(0.001)
        self.learning_rate_users = DefaultRate(0.001)
        self.learning_rate_items = DefaultRate(0.001)
        self.K = 0.05
        self.K2 = 0.01
        self.K3 = 0.01
        self.dimensionality = 40

        # 'auto' = the flagship per substrate: sorted-window alternating
        # on one device, alternating_sharded on a mesh (defaults match
        # the benchmarked path, as the reference's default train() IS
        # its fastest path, gradient_descent.py:545).  batch_size and
        # inner_steps are the headline operating point (W=128,
        # batch=16k, T=128); per-epoch train RMSE improves monotonically
        # with T on the bench's planted structure.  The sweep count is
        # tuned JOINTLY with batch_size/learning_rate: each inner sweep
        # re-iterates the same window, so if you shrink batch_size or
        # raise learning_rate well past the tuned point, reduce
        # inner_steps too or the per-window iteration can overshoot.
        self.engine = 'auto'
        self.batch_size = 16384
        self.inner_steps = 128           # alternating: grad iters / batch
        # The SVD++ (implicit) tier has its OWN sweep count: its
        # Y-aggregation phases couple rows across the batch, and past
        # T=32 the per-window iteration overshoots the Y coupling
        # (planted-structure train RMSE 0.5695 / 0.4436 / 0.3249 at
        # T=8/16/32, then WORSE, 0.3613, at T=64).  T=32 is the shipped
        # default.
        self.inner_steps_implicit = 32
        # Per-epoch multiplicative learning-rate decay on the
        # alternating engine — explicit AND implicit (SVD++) tiers
        # (1.0 = constant rate, the reference's
        # semantics — gd_estimator.pyx has no schedule).  The effective
        # rate at epoch e is lr * lr_decay**e, applied through ONE
        # compiled epoch program (the scale is a traced scalar operand,
        # sgd_mf.make_alternating_epoch lr_scale) — a schedule costs no
        # recompiles.  Constant-rate SGD plateaus at its step-noise
        # floor; decay trades early progress for a deeper floor, so it
        # only pays for quality-hungry runs.
        self.lr_decay = 1.0
        # Plateau-onset decay (ConvergenceDriver plateau_decay): when the
        # reference stop rule would end training, scale the rate by this
        # factor and continue (until the scale floors, then stop as
        # usual).  The ONLY decay shape that measured a win at ML-10M:
        # constant-to-plateau-then-decay breaks below the constant-rate
        # trajectory, while decay-from-epoch-0 loses at every target.
        # 1.0 disables (default —
        # reference semantics; quality-hungry runs set ~0.9 with a high
        # max_epochs).
        self.lr_plateau_decay = 1.0
        # Factor init for the JOINTLY-trained engines (alternating*/
        # fused/dsgd/implicit).  The reference's constant
        # np.full(feature_init) init (gradient_descent.py:523-525) is
        # correct ONLY for its feature-SEQUENTIAL Funk loop, where
        # features differentiate by training against the residual of
        # earlier ones.  Under JOINT training, a constant init is a
        # fixed point of the column-permutation symmetry: every factor
        # column receives the identical gradient forever and the model
        # collapses to rank 1 regardless of nbr_features (measured end
        # to end at the ML-10M bench shape: train RMSE stalls at 0.692,
        # a hair under the 0.703 bias floor, vs 0.29 with the symmetry
        # broken).  Same
        # latent-defect class as the reference's constant WRMF init
        # (models/wrmf.py init_mode notes).  'auto' (default):
        # N(0, feature_init) via self.rng for joint engines, the
        # reference-exact constant fill for the sequential tiers
        # ('funk'/'funk_fused', whose cached estimators also assume it
        # through the trailing term).  'normal'/'constant' force either.
        self.init_mode = 'auto'
        # alternating_sharded: rating shards trained in parallel and
        # parameter-averaged each epoch (the 2-D mesh's outer axis)
        self.n_slices = 1

        # Failure detection / recovery (engine.trainer.ResilientDriver;
        # a subsystem the reference lacks — SURVEY §5).  resilience = max
        # rollback-and-backoff recoveries (0 disables, plain
        # ConvergenceDriver + NaN guard); snapshots every
        # resilience_snapshot_every good epochs, optionally persisted to
        # resilience_dir for crash resume: when that directory holds a
        # compatible snapshot, train() CONTINUES from its epoch (clear
        # or change the directory to train fresh; a shape-mismatched
        # snapshot is ignored with a warning).
        self.resilience = 0
        self.resilience_snapshot_every = 5
        self.resilience_dir = None

        if parameters:
            self.set_parameters(parameters)

        self.rmse_history = []
        self.feedback_rated = None
        self.feedback_hash = None
        self.components_mean = None

    # --------------------------------------------------------------- utils
    def get_rmse_history(self):
        return np.asarray(self.rmse_history)

    def set_ratings_iterator(self, iterator):
        '''Ingest from an external (e.g. DB cursor) iterator of
        (user_index, item_index, value) rows (reference
        gradient_descent.py:111-112 keeps the cursor; here rows are
        drained into the ratings store).'''
        for row in iterator:
            self.ratings.set(int(row[0]), int(row[1]), float(row[2]))

    def feature_training_dev(self, initialize_model=True, probe=None,
                             verbose=False):
        '''Funk training returning the per-epoch rmse trace (reference
        gradient_descent.py:577-599 -> estimator_loop with rmse_hist
        out-param).'''
        self._init_factors(initialize_model, sequential=True)
        self._run_funk('none', verbose=verbose)
        return np.asarray(self.rmse_history)

    # feature-sequential tiers: the reference constant init is both
    # correct and load-bearing there (trailing-term estimates)
    _SEQUENTIAL_ENGINES = ('funk', 'funk_fused')

    def _init_factors(self, initialize_model, sequential=None):
        '''Factor init.  ``sequential`` overrides the engine-derived
        choice for entry points that hardwire a tier (e.g.
        ``feature_training_dev`` always runs the funk loop regardless of
        ``self.engine``).  See the ``init_mode`` notes in ``__init__``:
        constant init under joint training collapses the model to
        rank 1.'''
        if not (initialize_model or self.P is None or self.Q is None):
            return
        k = self.dimensionality
        mode = getattr(self, 'init_mode', 'auto')
        if mode not in ('auto', 'constant', 'normal'):
            raise Error("init_mode must be 'auto', 'constant' or "
                        "'normal' (got %r)" % (mode,))
        if mode == 'auto':
            seq = (sequential if sequential is not None
                   else self.engine in self._SEQUENTIAL_ENGINES)
            mode = 'constant' if seq else 'normal'
        if mode == 'constant':
            self.P = np.full((self.nbr_users, k), self.feature_init,
                             np.float32)
            self.Q = np.full((self.nbr_items, k), self.feature_init,
                             np.float32)
        else:
            scale = abs(float(self.feature_init))
            if scale == 0.0:
                # an all-zero init is itself a training fixed point for
                # joint engines (zero factor gradients with fixed biases)
                # — the same silent-collapse class init_mode='auto' is
                # meant to prevent
                raise Error(
                    "feature_init must be non-zero for init_mode="
                    "'normal' (an all-zero init freezes joint training; "
                    "set feature_init, e.g. 0.05)")
            self.P = self.rng.normal(0.0, scale, (self.nbr_users, k)) \
                .astype(np.float32)
            self.Q = self.rng.normal(0.0, scale, (self.nbr_items, k)) \
                .astype(np.float32)

    def _zero_biases(self):
        return (np.zeros(self.nbr_users, np.float32),
                np.zeros(self.nbr_items, np.float32))

    def _state(self, with_bias, mu=None):
        bu = self.users_bias if (with_bias and self.users_bias is not None) \
            else np.zeros(self.nbr_users, np.float32)
        bi = self.items_bias if (with_bias and self.items_bias is not None) \
            else np.zeros(self.nbr_items, np.float32)
        Y = self.Y if self.Y is not None \
            else np.zeros_like(self.Q)
        return sgd_mf.MFState(
            P=jnp.asarray(self.P, jnp.float32),
            Q=jnp.asarray(self.Q, jnp.float32),
            bu=jnp.asarray(bu, jnp.float32),
            bi=jnp.asarray(bi, jnp.float32),
            mu=jnp.float32(mu if mu is not None else (self.overall_bias or 0.0)),
            Y=jnp.asarray(Y, jnp.float32))

    def _writeback(self, state, with_bias=False, with_y=False):
        self.P = np.array(state.P)
        self.Q = np.array(state.Q)
        if with_bias:
            self.users_bias = np.array(state.bu)
            self.items_bias = np.array(state.bi)
        if with_y:
            self.Y = np.array(state.Y)

    # ------------------------------------------------------- fused engine
    def _run_fused(self, bias_mode, verbose=False, ratings=None, seed=None):
        if ratings is None:
            (uidx, iidx, vals) = self.ratings.coo()
        else:
            uidx, iidx, vals = ratings
        ub, ib, rb, mb = sgd_mf.batch_ratings(
            uidx, iidx, vals, self.batch_size,
            seed=seed if seed is not None else int(self.rng.integers(2**31)))
        ub, ib = jnp.asarray(ub), jnp.asarray(ib)
        rb, mb = jnp.asarray(rb), jnp.asarray(mb)
        epoch = sgd_mf.make_fused_epoch(
            self.batch_size, self.learning_rate, self.K,
            lr_bu=self.learning_rate_users, lr_bi=self.learning_rate_items,
            K_bu=self.K2, K_bi=self.K3, bias_mode=bias_mode,
            lo=self.min_rating, hi=self.max_rating)
        state = self._state(with_bias=(bias_mode != 'none'))
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement)
        state = driver.run(
            lambda s: epoch(s, ub, ib, rb, mb), state)
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        self._writeback(state, with_bias=(bias_mode == 'learned'))

    # -------------------------------------------------- funk_fused engine
    def _run_funk_fused(self, bias_mode, verbose=False):
        '''The reference's feature-by-feature Funk schedule (rating cache,
        trailing term, per-feature convergence) at mini-batch speed —
        the scalable middle ground between the exact serial tier and the
        all-features tiers.  bias_mode 'learned' uses the full-dot
        formulation of the reference's learned loop with an off-feature
        dot cache (see make_funk_fused_learned_epoch).'''
        if bias_mode == 'learned':
            return self._run_funk_fused_learned(verbose)
        uidx, iidx, vals = self.ratings.shuffled(int(self.rng.integers(2**31)))
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size)
        ub, ib = jnp.asarray(ub), jnp.asarray(ib)
        rb, mb = jnp.asarray(rb), jnp.asarray(mb)
        if bias_mode == 'fixed':
            base = (self.overall_bias + self.items_bias[np.asarray(ib)]
                    + self.users_bias[np.asarray(ub)]).astype(np.float32)
        else:
            base = np.ones(ub.shape, np.float32)
        cb = jnp.asarray(base)
        P = jnp.asarray(self.P, jnp.float32)
        Q = jnp.asarray(self.Q, jnp.float32)
        k = self.dimensionality
        epoch = sgd_mf.make_funk_fused_feature_epoch(
            self.learning_rate, self.K, bias_mode=bias_mode,
            lo=self.min_rating, hi=self.max_rating)
        self.rmse_history = []
        for f in range(k):
            pf = P[:, f:f + 1]
            qf = Q[:, f:f + 1]
            trailing = jnp.float32((k - f - 1) * self.feature_init ** 2)
            rmse, ep = 2.0, 0
            rmse_last = rmse
            while (ep < self.min_epochs
                   or rmse <= rmse_last - self.min_improvement):
                if ep >= self.max_epochs:
                    break
                rmse_last = rmse
                pf, qf, rmse_dev = epoch(pf, qf, trailing, ub, ib, rb, mb,
                                         cb)
                rmse = float(rmse_dev)
                self.rmse_history.append(rmse)
                ep += 1
            P = P.at[:, f:f + 1].set(pf)
            Q = Q.at[:, f:f + 1].set(qf)
            cb = sgd_mf.funk_fused_update_cache(pf, qf, ub, ib, cb,
                                                lo=self.min_rating,
                                                hi=self.max_rating)
            if verbose:
                self.logger.info('feature %d epochs %d rmse %.5f',
                                 f, ep, rmse)
        self.P, self.Q = np.array(P), np.array(Q)

    def _run_funk_fused_learned(self, verbose=False):
        '''Feature-by-feature learned-bias training at mini-batch speed
        (the funk_fused analogue of gd_estimator.pyx:401-483).'''
        uidx, iidx, vals = self.ratings.shuffled(
            int(self.rng.integers(2 ** 31)))
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size)
        ub, ib = jnp.asarray(ub), jnp.asarray(ib)
        rb, mb = jnp.asarray(rb), jnp.asarray(mb)
        P = jnp.asarray(self.P, jnp.float32)
        Q = jnp.asarray(self.Q, jnp.float32)
        bu = jnp.asarray(self.users_bias, jnp.float32)
        bi = jnp.asarray(self.items_bias, jnp.float32)
        mu = jnp.float32(self.overall_bias or 0.0)
        k = self.dimensionality
        epoch = sgd_mf.make_funk_fused_learned_epoch(
            self.learning_rate, self.learning_rate_users,
            self.learning_rate_items, self.K, self.K2, self.K3,
            lo=self.min_rating, hi=self.max_rating)
        full_dot = (P[ub] * Q[ib]).sum(-1)       # [nb, B] stream cache
        self.rmse_history = []
        for f in range(k):
            pf = P[:, f:f + 1]
            qf = Q[:, f:f + 1]
            off = full_dot - pf[ub, 0] * qf[ib, 0]
            trailing = jnp.float32((k - f - 1) * self.feature_init ** 2)
            rmse, ep = 2.0, 0
            rmse_last = rmse
            while (ep < self.min_epochs
                   or rmse <= rmse_last - self.min_improvement):
                if ep >= self.max_epochs:
                    break
                rmse_last = rmse
                pf, qf, bu, bi, rmse_dev = epoch(pf, qf, bu, bi, mu,
                                                 trailing, ub, ib, rb, mb,
                                                 off)
                rmse = float(rmse_dev)
                self.rmse_history.append(rmse)
                ep += 1
            P = P.at[:, f:f + 1].set(pf)
            Q = Q.at[:, f:f + 1].set(qf)
            full_dot = off + pf[ub, 0] * qf[ib, 0]
            if verbose:
                self.logger.info('feature %d epochs %d rmse %.5f',
                                 f, ep, rmse)
        self.P, self.Q = np.array(P), np.array(Q)
        self.users_bias, self.items_bias = np.array(bu), np.array(bi)

    def _alt_lrs(self):
        '''Learning rates for the alternating (row-MEAN step) tiers.

        The alternating engine applies one AVERAGED gradient step per
        touched factor row per batch, so a per-sample rate like the
        reference default 0.001 barely moves it.  When the user has not
        explicitly set a rate, use the benchmarked row-mean default
        (0.15 — the README headline operating point); an explicit value
        always wins.  Engines with per-sample semantics (funk, fused,
        dsgd) keep the reference defaults untouched.'''
        def chosen(attr):
            # ANY plain-float assignment (direct, set_parameters, sweep)
            # replaces the DefaultRate sentinel, so even assigning the
            # reference default value itself counts as a user choice
            return not isinstance(getattr(self, attr), DefaultRate)

        if chosen('learning_rate'):
            lr = float(self.learning_rate)
        else:
            lr = 0.15
            self.logger.info(
                'alternating engine: learning_rate not set; using the '
                'row-mean default 0.15 (the per-sample reference default '
                '0.001 barely moves averaged steps — assign '
                'learning_rate explicitly to override)')
        lr_bu = float(self.learning_rate_users) \
            if chosen('learning_rate_users') else lr
        lr_bi = float(self.learning_rate_items) \
            if chosen('learning_rate_items') else lr
        return lr, lr_bu, lr_bi

    # _alternating_layouts (the version-keyed layout cache) is inherited
    # from MFRecommender — shared with the KMF alternating engine.

    # ------------------------------------------------- alternating engine
    def _run_alternating(self, bias_mode, verbose=False):
        '''Scatter-free sorted-window epochs
        (``ops.sgd_mf.make_alternating_epoch``) — the single-device
        flagship; blockwise-alternating update order.'''
        # chunk = the whole batch (the XLA sweeps' one-hot aggregation)
        chunk = self.batch_size
        lr, lr_bu, lr_bi = self._alt_lrs()
        # W=128 converges better per epoch than wider windows
        mw = min(128, max(self.nbr_users, self.nbr_items))
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(mw)
        state = self._state(with_bias=(bias_mode != 'none'))
        Paug, Qaug = sgd_mf.augment_factors(
            jnp.pad(state.P, ((0, W_user), (0, 0))),
            jnp.pad(state.Q, ((0, W_item), (0, 0))),
            jnp.pad(state.bu, (0, W_user)),
            jnp.pad(state.bi, (0, W_item)))
        mu = state.mu

        def build_epoch():
            return sgd_mf.make_alternating_epoch(
                W_user, W_item, lr, self.K,
                lr_bu=lr_bu, lr_bi=lr_bi,
                K_bu=self.K2, K_bi=self.K3, bias_mode=bias_mode,
                lo_r=self.min_rating, hi_r=self.max_rating, chunk=chunk,
                inner_steps=self.inner_steps,
                # the kernel gathers a bf16 fixed side (an accepted
                # mixed-precision deviation; the XLA sweeps read f32)
                ff_dtype='bfloat16')

        decay = float(self.lr_decay)
        if not (0.0 < decay <= 1.0):
            raise Error('lr_decay must be in (0, 1] (got %r)'
                        % self.lr_decay)
        plateau = float(self.lr_plateau_decay)
        if not (0.0 < plateau <= 1.0):
            raise Error('lr_plateau_decay must be in (0, 1] (got %r)'
                        % self.lr_plateau_decay)
        driver_ref = []                  # filled once the driver exists

        def one_epoch_of(epoch, scale=None):
            # With a schedule (decay<1), plateau decay, or a resilience
            # backoff (scale<1) the per-epoch rate rides the TRACED
            # lr_scale arg of the compiled epoch — one program for the
            # whole schedule.  The exponent is the driver's history
            # length, so it rewinds with ResilientDriver rollbacks and
            # continues across crash resume.  scale=None reads the
            # driver's own lr_scale (ConvergenceDriver plateau decay);
            # the resilient path passes its backoff scale explicitly
            # (its lr_scale IS that backoff — reading both would square
            # it).

            def one_epoch(pq):
                Paug, Qaug = pq
                s = (driver_ref[0].lr_scale if scale is None and driver_ref
                     else (scale if scale is not None else 1.0))
                if decay == 1.0 and s == 1.0:
                    Paug, Qaug, rmse = epoch(Paug, Qaug, mu, p_layout,
                                             q_layout)
                else:
                    e = len(driver_ref[0].history) if driver_ref else 0
                    Paug, Qaug, rmse = epoch(
                        Paug, Qaug, mu, p_layout, q_layout,
                        jnp.float32(s * decay ** e))
                return (Paug, Qaug), rmse
            return one_epoch

        if int(self.resilience) > 0:
            def factors_healthy(pq, _cap=1e8):
                # finite AND bounded: with clamped predictions the RMSE
                # stays in the rating range while diverging factors race
                # to f32 overflow, so magnitude is the real signal
                Pa, Qa = pq
                ok = (jnp.isfinite(Pa).all() & jnp.isfinite(Qa).all()
                      & (jnp.max(jnp.abs(Pa)) < _cap)
                      & (jnp.max(jnp.abs(Qa)) < _cap))
                return bool(ok)

            driver = ResilientDriver(
                self.min_epochs, self.max_epochs, self.min_improvement,
                snapshot_every=self.resilience_snapshot_every,
                max_retries=int(self.resilience),
                checkpoint_dir=self.resilience_dir,
                state_guard=factors_healthy)
            driver_ref.append(driver)
            # recovery backoff rides the traced lr_scale too — a
            # rollback no longer recompiles the epoch
            epoch0 = build_epoch()
            Paug, Qaug = driver.run(
                lambda s: one_epoch_of(epoch0, scale=s), (Paug, Qaug))
            if driver.recoveries:
                self.logger.info(
                    'resilient training: %d rollback(s), final lr scale '
                    '%g', driver.recoveries, driver.lr_scale)
        else:
            driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                       self.min_improvement,
                                       plateau_decay=plateau)
            driver_ref.append(driver)
            Paug, Qaug = driver.run(one_epoch_of(build_epoch()),
                                    (Paug, Qaug))
            if plateau < 1.0 and driver.lr_scale < 1.0:
                self.logger.info(
                    'plateau decay engaged: final lr scale %g',
                    driver.lr_scale)
        self.rmse_history = driver.history
        P, Q, bu, bi = sgd_mf.split_factors(Paug, Qaug)
        self.P = np.array(P)[:self.nbr_users]
        self.Q = np.array(Q)[:self.nbr_items]
        if bias_mode == 'learned':
            self.users_bias = np.array(bu)[:self.nbr_users]
            self.items_bias = np.array(bi)[:self.nbr_items]
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    # -------------------------------------- alternating_sharded engine
    def _run_alternating_sharded(self, bias_mode, verbose=False,
                                 n_devices=None, ring=False):
        '''The flagship engine over the device mesh
        (``parallel.alternating_sharded``): users/items range-partitioned
        into row shards, each device trains its own rows' sorted-window
        batches, one all_gather of each factor side per epoch.

        ``ring=True`` (engine='alternating_ring') swaps the all_gather
        for a D-round ppermute shard rotation
        (``parallel.ring_alternating``) — no read-side replica in memory,
        same total bytes moved.'''
        import jax
        from mfrec_tpu.parallel import alternating_sharded as alt
        from mfrec_tpu.parallel.mesh import make_mesh
        if bias_mode == 'learned' and ring:
            raise Error("engine='alternating_ring' supports bias modes "
                        "'none'/'fixed'; use engine='alternating_sharded' "
                        "for learned biases on a mesh")
        S = int(self.n_slices)
        if ring and S > 1:
            raise Error("engine='alternating_ring' is single-slice; "
                        "use engine='alternating_sharded' with n_slices")
        D = n_devices or len(jax.devices()) // S
        uidx, iidx, vals = self.ratings.coo()
        max_window = min(256, max(self.nbr_users, self.nbr_items))
        if ring:
            from mfrec_tpu.parallel import ring_alternating as ring_mod
            mesh = make_mesh(D)
            slice_axis = None
            p_layout, q_layout, (Ushard, Ishard, W) = \
                ring_mod.build_ring_alternating_layout(
                    uidx, iidx, vals, D, self.nbr_users, self.nbr_items,
                    batch_size=self.batch_size, max_window=max_window)
        elif S > 1:
            from mfrec_tpu.parallel.mesh import make_mesh_2d
            mesh = make_mesh_2d(S, D)
            slice_axis = 'slice'
            p_layout, q_layout, (Ushard, Ishard, W) = \
                alt.build_multislice_alternating_layout(
                    uidx, iidx, vals, S, D, self.nbr_users, self.nbr_items,
                    batch_size=self.batch_size, max_window=max_window,
                    seed=int(self.rng.integers(2 ** 31)))
        else:
            mesh = make_mesh(D)
            slice_axis = None
            p_layout, q_layout, (Ushard, Ishard, W) = \
                alt.build_sharded_alternating_layout(
                    uidx, iidx, vals, D, self.nbr_users, self.nbr_items,
                    batch_size=self.batch_size, max_window=max_window)
        bu, bi = self._zero_biases()
        if bias_mode != 'none':
            bu = self.users_bias if self.users_bias is not None else bu
            bi = self.items_bias if self.items_bias is not None else bi
        Paug, Qaug = sgd_mf.augment_factors(
            np.asarray(self.P, np.float32), np.asarray(self.Q, np.float32),
            np.asarray(bu, np.float32), np.asarray(bi, np.float32))
        Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
        Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
        mu = jnp.float32(self.overall_bias or 0.0)
        p_dev = tuple(jnp.asarray(x) for x in p_layout)
        q_dev = tuple(jnp.asarray(x) for x in q_layout)
        lr, lr_bu, lr_bi = self._alt_lrs()
        if ring:
            epoch = ring_mod.make_ring_alternating_epoch(
                mesh, W, lr=lr, K=self.K,
                bias_mode=bias_mode,
                lo_r=self.min_rating, hi_r=self.max_rating,
                chunk=min(8192, self.batch_size),
                inner_steps=self.inner_steps)
        else:
            epoch = alt.make_sharded_alternating_epoch(
                mesh, W, lr=lr, K=self.K,
                bias_mode=bias_mode,
                lr_bu=lr_bu, lr_bi=lr_bi,
                K_bu=self.K2, K_bi=self.K3,
                lo_r=self.min_rating, hi_r=self.max_rating,
                chunk=min(8192, self.batch_size),
                inner_steps=self.inner_steps, slice_axis=slice_axis)
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement)

        def one_epoch(pq):
            Pa, Qa = pq
            Pa, Qa, rmse = epoch(Pa, Qa, mu, *p_dev, *q_dev)
            return (Pa, Qa), rmse

        Paug, Qaug = driver.run(one_epoch, (Paug, Qaug))
        self.rmse_history = driver.history
        Pa = alt.unpad_factors_sharded(np.asarray(Paug), Ushard, W, D,
                                       self.nbr_users)
        Qa = alt.unpad_factors_sharded(np.asarray(Qaug), Ishard, W, D,
                                       self.nbr_items)
        k = self.dimensionality
        self.P, self.Q = Pa[:, :k], Qa[:, :k]
        if bias_mode == 'learned':
            self.users_bias = Pa[:, k].copy()
            self.items_bias = Qa[:, k + 1].copy()
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    # ------------------------------------------- alternating SVD++ engine
    def _run_alternating_implicit(self, verbose=False):
        '''SVD++ at sorted-window speed: every phase (Y aggregation, both
        half-passes, error aggregation, Y update) is scatter-free window
        work (``ops.sgd_mf.make_alternating_implicit_epoch``).'''
        chunk = min(8192, self.batch_size)
        lr, _, _ = self._alt_lrs()
        # NOT the plain tier's W=128 optimum: the Y-aggregation phases
        # couple rows across the batch, and narrow windows diverge at
        # bench-scale learning rates (measured: train RMSE 2.20 > floor
        # at W=128/batch=16k vs 0.652 at W=512/32k)
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(512)
        k = self.dimensionality
        state = self._state(with_bias=True)
        Paug, Qaug = sgd_mf.augment_factors(
            jnp.pad(state.P, ((0, W_user), (0, 0))),
            jnp.pad(state.Q, ((0, W_item), (0, 0))),
            jnp.pad(state.bu, (0, W_user)),
            jnp.pad(state.bi, (0, W_item)))
        Ypad = jnp.zeros((self.nbr_items + W_item, k), jnp.float32)
        counts = self.ratings.user_counts().astype(np.float32)
        nrm = np.zeros(self.nbr_users + W_user, np.float32)
        nrm[:self.nbr_users] = np.where(counts > 0,
                                        1.0 / np.sqrt(np.maximum(counts,
                                                                 1.0)),
                                        0.0)
        nrm_rows = jnp.asarray(nrm)
        mu = state.mu
        # the fixed side stays f32: bf16 rounding hurts the Y-coupled
        # convergence
        epoch = sgd_mf.make_alternating_implicit_epoch(
            W_user, W_item, lr, lr,
            self.K, self.K, lo_r=self.min_rating, hi_r=self.max_rating,
            chunk=chunk, inner_steps=self.inner_steps_implicit)
        decay = float(self.lr_decay)
        if not (0.0 < decay <= 1.0):
            raise Error('lr_decay must be in (0, 1] (got %r)'
                        % self.lr_decay)
        plateau = float(self.lr_plateau_decay)
        if not (0.0 < plateau <= 1.0):
            raise Error('lr_plateau_decay must be in (0, 1] (got %r)'
                        % self.lr_plateau_decay)
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement,
                                   plateau_decay=plateau)

        def one_epoch(st):
            Pa, Qa, Yp = st
            if decay == 1.0 and driver.lr_scale == 1.0:
                Pa, Qa, Yp, rmse = epoch(Pa, Qa, Yp, mu, p_layout,
                                         q_layout, nrm_rows)
            else:
                # schedule rides the traced lr_scale (P/Q half-passes
                # AND the Y step scale together — one compiled program)
                e = len(driver.history)
                Pa, Qa, Yp, rmse = epoch(
                    Pa, Qa, Yp, mu, p_layout, q_layout, nrm_rows,
                    jnp.float32(driver.lr_scale * decay ** e))
            return (Pa, Qa, Yp), rmse

        Paug, Qaug, Ypad = driver.run(one_epoch, (Paug, Qaug, Ypad))
        if plateau < 1.0 and driver.lr_scale < 1.0:
            self.logger.info('plateau decay engaged: final lr scale %g',
                             driver.lr_scale)
        self.rmse_history = driver.history
        P, Q, bu, bi = sgd_mf.split_factors(Paug, Qaug)
        self.P = np.array(P)[:self.nbr_users]
        self.Q = np.array(Q)[:self.nbr_items]
        self.Y = np.array(Ypad)[:self.nbr_items]
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    def _run_alternating_implicit_sharded(self, verbose=False,
                                          n_devices=None):
        '''SVD++ over the device mesh (``parallel.implicit_sharded``):
        the five windowed phases of the single-chip implicit tier, with
        users/items range-partitioned like the plain sharded engine and
        4 all_gathers per epoch (Y, Q, Peff, G).'''
        import jax
        from mfrec_tpu.parallel import alternating_sharded as alt
        from mfrec_tpu.parallel import implicit_sharded as imp
        from mfrec_tpu.parallel.mesh import make_mesh
        D = n_devices or len(jax.devices())
        mesh = make_mesh(D)
        uidx, iidx, vals = self.ratings.coo()
        # same wide-window rule as the single-chip implicit tier: the
        # Y-aggregation phases couple rows across the batch, and narrow
        # windows diverge at bench-scale learning rates
        max_window = min(512, max(self.nbr_users, self.nbr_items))
        p_layout, q_layout, (Ushard, Ishard, W) = \
            alt.build_sharded_alternating_layout(
                uidx, iidx, vals, D, self.nbr_users, self.nbr_items,
                batch_size=self.batch_size, max_window=max_window)
        self._ensure_bias_arrays()
        k = self.dimensionality
        Paug, Qaug = sgd_mf.augment_factors(
            np.asarray(self.P, np.float32), np.asarray(self.Q, np.float32),
            np.asarray(self.users_bias, np.float32),
            np.asarray(self.items_bias, np.float32))
        Paug = jnp.asarray(alt.pad_factors_sharded(Paug, Ushard, W, D))
        Qaug = jnp.asarray(alt.pad_factors_sharded(Qaug, Ishard, W, D))
        Ypad = jnp.zeros((D * (Ishard + W), k), jnp.float32)
        counts = self.ratings.user_counts().astype(np.float32)
        nrm_host = np.where(counts > 0,
                            1.0 / np.sqrt(np.maximum(counts, 1.0)),
                            0.0).astype(np.float32)
        nrm = jnp.asarray(alt.pad_factors_sharded(
            nrm_host[:, None], Ushard, W, D)[:, 0])
        mu = jnp.float32(self.overall_bias or 0.0)
        lr, _, _ = self._alt_lrs()
        epoch = imp.make_sharded_implicit_epoch(
            mesh, W, lr=lr, lr_y=lr, K=self.K, K_y=self.K,
            lo_r=self.min_rating, hi_r=self.max_rating,
            chunk=min(8192, self.batch_size),
            inner_steps=self.inner_steps_implicit)
        p_dev = tuple(jnp.asarray(x) for x in p_layout)
        q_dev = tuple(jnp.asarray(x) for x in q_layout)
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement)

        def one_epoch(st):
            Pa, Qa, Yp = st
            Pa, Qa, Yp, rmse = epoch(Pa, Qa, Yp, mu, nrm, *p_dev, *q_dev)
            return (Pa, Qa, Yp), rmse

        Paug, Qaug, Ypad = driver.run(one_epoch, (Paug, Qaug, Ypad))
        self.rmse_history = driver.history
        Pa = alt.unpad_factors_sharded(np.asarray(Paug), Ushard, W, D,
                                       self.nbr_users)
        Qa = alt.unpad_factors_sharded(np.asarray(Qaug), Ishard, W, D,
                                       self.nbr_items)
        self.P, self.Q = Pa[:, :k], Qa[:, :k]
        self.Y = alt.unpad_factors_sharded(np.asarray(Ypad), Ishard, W, D,
                                           self.nbr_items)
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    # -------------------------------------------------------- dsgd engine
    def _run_dsgd(self, bias_mode, verbose=False, n_devices=None):
        '''Ring-DSGD training over all visible devices
        (``mfrec_tpu.parallel.dsgd``): user-sharded P, item shards rotating
        between devices.  Used when engine='dsgd'; works on a 1-device mesh too.'''
        import jax
        from mfrec_tpu.parallel import dsgd as dsgd_mod
        from mfrec_tpu.parallel.mesh import make_mesh
        if bias_mode == 'learned':
            raise Error("engine='dsgd' supports bias modes 'none'/'fixed'; "
                        "use engine='alternating_sharded' for learned "
                        "biases on a mesh")
        D = n_devices or len(jax.devices())
        mesh = make_mesh(D)
        uidx, iidx, vals = self.ratings.coo()
        blocks, (Ub, Ib) = dsgd_mod.build_dsgd_blocks(
            uidx, iidx, vals, D, self.nbr_users, self.nbr_items,
            seed=int(self.rng.integers(2**31)))
        bu, bi = self._zero_biases()
        if bias_mode != 'none':
            bu = self.users_bias if self.users_bias is not None else bu
            bi = self.items_bias if self.items_bias is not None else bi
        P = jnp.asarray(dsgd_mod.pad_factors(self.P, Ub, D))
        Q = jnp.asarray(dsgd_mod.pad_factors(self.Q, Ib, D))
        bu = jnp.asarray(dsgd_mod.pad_factors(np.asarray(bu, np.float32),
                                              Ub, D))
        bi = jnp.asarray(dsgd_mod.pad_factors(np.asarray(bi, np.float32),
                                              Ib, D))
        mu = jnp.float32(self.overall_bias or 0.0)
        dev_blocks = [jnp.asarray(b) for b in blocks]
        epoch_fn = dsgd_mod.make_ring_dsgd_epoch(
            mesh, lr=self.learning_rate, K=self.K, bias_mode=bias_mode,
            lo=self.min_rating, hi=self.max_rating)
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement)

        def one_epoch(state):
            P, Q, bu, bi = state
            P, Q, bu, bi, rmse = epoch_fn(P, Q, bu, bi, mu, *dev_blocks)
            return (P, Q, bu, bi), rmse

        (P, Q, bu, bi) = driver.run(one_epoch, (P, Q, bu, bi))
        self.rmse_history = driver.history
        self.P = np.array(P)[:self.nbr_users]
        self.Q = np.array(Q)[:self.nbr_items]
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    # -------------------------------------------------------- funk engine
    def _run_funk(self, bias_mode, verbose=False, update_users=True,
                  update_items=True, ratings=None):
        '''Feature-by-feature training with exact reference semantics
        (gd_estimator.pyx:489-582 / :691-779 / :401-483).'''
        if ratings is None:
            uidx, iidx, vals = self.ratings.shuffled(
                int(self.rng.integers(2**31)))
        else:
            uidx, iidx, vals = ratings
        uidx = jnp.asarray(uidx, jnp.int32)
        iidx = jnp.asarray(iidx, jnp.int32)
        r = jnp.asarray(vals, jnp.float32)
        n = int(r.shape[0])
        k = self.dimensionality
        P = jnp.asarray(self.P, jnp.float32)
        Q = jnp.asarray(self.Q, jnp.float32)
        bu, bi = self._zero_biases()
        if bias_mode != 'none':
            bu = self.users_bias if self.users_bias is not None else bu
            bi = self.items_bias if self.items_bias is not None else bi
        bu, bi = jnp.asarray(bu, jnp.float32), jnp.asarray(bi, jnp.float32)
        mu = jnp.float32(self.overall_bias or 0.0)
        cache = jnp.zeros((n,), jnp.float32)
        self.rmse_history = []

        for f in range(k):
            pf, qf = P[:, f], Q[:, f]
            rmse, epoch = 2.0, 0
            rmse_last = rmse
            while (epoch < self.min_epochs
                   or rmse <= rmse_last - self.min_improvement):
                if epoch >= self.max_epochs:
                    break
                rmse_last = rmse
                pf, qf, bu, bi, rmse_dev = sgd_mf.serial_feature_epoch(
                    pf, qf, cache, uidx, iidx, r, f, k, self.feature_init,
                    self.learning_rate, self.K, mu, bu, bi,
                    self.learning_rate_users, self.learning_rate_items,
                    self.K2, self.K3, bias_mode=bias_mode,
                    lo=self.min_rating, hi=self.max_rating,
                    update_users=update_users, update_items=update_items,
                    P=P, Q=Q)
                rmse = float(rmse_dev)
                self.rmse_history.append(rmse)
                epoch += 1
            P = P.at[:, f].set(pf)
            Q = Q.at[:, f].set(qf)
            if bias_mode != 'learned':
                cache = sgd_mf.update_cache(pf, qf, cache, uidx, iidx, mu,
                                            bu, bi, bias_mode=bias_mode,
                                            lo=self.min_rating,
                                            hi=self.max_rating)
            if verbose:
                self.logger.info('feature %d epochs %d rmse %.5f',
                                 f, epoch, rmse)
        self.P, self.Q = np.array(P), np.array(Q)
        if bias_mode == 'learned':
            self.users_bias = np.array(bu)
            self.items_bias = np.array(bi)

    # ------------------------------------------------------------ training
    def feature_training(self, initialize_model=True, handle_bias=False,
                         verbose=False):
        '''Main SGD training (reference gradient_descent.py:506-542).
        handle_bias=False -> baseline 1.0 (estimator_loop_without_bias);
        handle_bias=True -> fixed BellKor biases precomputed then held
        (estimator_loop_with_bias).'''
        self._init_factors(initialize_model)
        if handle_bias:
            self.compute_overall_avg()
            self.compute_items_bias_bk()
            self.compute_users_bias_bk()
            mode = 'fixed'
        else:
            mode = 'none'
        self._dispatch_engine(mode, verbose)

    def _dispatch_engine(self, mode, verbose):
        '''engine='auto' picks the flagship path for the hardware:
        alternating_sharded when >1 device, alternating otherwise.'''
        engine = self.engine
        if engine == 'auto':
            import jax
            engine = ('alternating_sharded' if len(jax.devices()) > 1
                      else 'alternating')
        if int(self.resilience) > 0 and engine != 'alternating':
            # ResilientDriver is wired into _run_alternating only;
            # silently ignoring a requested reliability feature would be
            # worse than refusing (engine='alternating' forces the
            # resilient path even on a multi-device auto pick)
            raise Error(
                "resilience is only wired on engine='alternating' "
                "(got %r); set engine='alternating' or resilience=0"
                % (engine,))
        if float(self.lr_decay) != 1.0 and engine != 'alternating':
            # same refusal contract as resilience: a requested schedule
            # silently ignored on another engine would train at the
            # wrong rates
            raise Error(
                "lr_decay is only wired on engine='alternating' "
                "(got %r); set engine='alternating' or lr_decay=1.0"
                % (engine,))
        if float(self.lr_plateau_decay) != 1.0:
            if engine != 'alternating':
                raise Error(
                    "lr_plateau_decay is only wired on "
                    "engine='alternating' (got %r)" % (engine,))
            if int(self.resilience) > 0:
                # ResilientDriver owns lr_scale for rollback backoff;
                # plateau decay rides ConvergenceDriver only
                raise Error('lr_plateau_decay and resilience>0 are '
                            'mutually exclusive (the resilient driver '
                            'uses its lr scale for rollback backoff)')
        if engine == 'funk':
            self._run_funk(mode, verbose=verbose)
        elif engine == 'funk_fused':
            self._run_funk_fused(mode, verbose=verbose)
        elif engine == 'dsgd':
            self._run_dsgd(mode, verbose=verbose)
        elif engine == 'alternating':
            self._run_alternating(mode, verbose=verbose)
        elif engine == 'alternating_sharded':
            self._run_alternating_sharded(mode, verbose=verbose)
        elif engine == 'alternating_ring':
            self._run_alternating_sharded(mode, verbose=verbose, ring=True)
        elif engine == 'fused':
            self._run_fused(mode, verbose=verbose)
        else:
            raise Error('unknown engine %r' % (engine,))

    train = feature_training

    def feature_training_bias(self, initialize_model=True, handle_bias=False,
                              verbose=False):
        '''SGD with *learned* biases (reference gradient_descent.py:472-503
        -> estimator_loop_with_learned_bias).'''
        self._init_factors(initialize_model)
        self.compute_overall_avg()
        self.compute_items_bias_bk()
        self.compute_users_bias_bk()
        self._dispatch_engine('learned', verbose)

    def feature_training_implicit(self, initialize_model=True, verbose=False):
        '''SVD++-style training with implicit feedback factors
        (reference gradient_descent.py:547-574).  All engines route
        through the scatter-free windowed Y-aggregation tier, which
        handles EXACT |N(u)| for every user (the r2 fused-implicit tier
        truncated heavy users' feedback lists at feedback_cap=128 — a
        silent quality cliff at ML-10M scale, removed per r2 verdict
        weak #3; the capped-list fused epoch survives only as an
        ops-level kernel variant).  The reference's serial loop is
        defective (SURVEY.md §2.6) so there is no order-faithful oracle
        to honor.'''
        self._init_factors(initialize_model, sequential=False)  # joint
        self.compute_overall_avg()
        self.compute_items_bias_bk()
        self.compute_users_bias_bk()
        self.initialize_rated_feedback()
        self.Y = np.zeros_like(self.Q)
        engine = self.engine
        if engine == 'auto':
            import jax
            engine = ('alternating_sharded' if len(jax.devices()) > 1
                      else 'alternating')
        if engine == 'alternating_sharded':
            # same refusal contract as _dispatch_engine: a requested
            # schedule silently ignored would train at the wrong rates
            if float(self.lr_decay) != 1.0 or \
                    float(self.lr_plateau_decay) != 1.0:
                raise Error(
                    'lr_decay/lr_plateau_decay are only wired on the '
                    "single-device implicit tier (engine='alternating'); "
                    'got engine=%r' % (engine,))
            self._run_alternating_implicit_sharded(verbose=verbose)
        else:
            self._run_alternating_implicit(verbose=verbose)

    def feature_training2(self, initialize_model=True, verbose=False):
        '''Caller-controlled funk subloops (reference
        gradient_descent.py:299-328) — same semantics as engine='funk'.'''
        self._init_factors(initialize_model, sequential=True)
        self._run_funk('none', verbose=verbose)

    def feature_training_folding(self, initialize_model=False,
                                 handle_bias=False, verbose=False):
        '''Warm-start continuation (reference gradient_descent.py:450-469).'''
        self.feature_training(initialize_model=initialize_model,
                              handle_bias=handle_bias, verbose=verbose)
        self.compute_components_mean()

    def feature_training_batch(self, batch_size=10000, probeset=None,
                               verbose=False):
        '''Sequential mini-batch / online training over rating chunks
        (reference gradient_descent.py:331-355).'''
        from mfrec_tpu.eval.metrics import test_predict_rating
        idx, vals = self.get_ratings(randomize_order=False)
        n = idx.shape[0]
        nbr_batchs = max(n // batch_size, 1)
        bounds = np.linspace(0, n, nbr_batchs + 1).astype(int)
        rmse_probe = np.zeros(nbr_batchs)
        self._init_factors(True, sequential=False)   # fused = joint
        for b in range(nbr_batchs):
            chunk = (idx[bounds[b]:bounds[b + 1], 0],
                     idx[bounds[b]:bounds[b + 1], 1],
                     vals[bounds[b]:bounds[b + 1]].astype(np.float32))
            self._run_fused('none', ratings=chunk, verbose=verbose)
            if probeset is not None:
                rmse_probe[b] = test_predict_rating(
                    self, probeset, nbr_samples=20000, quiet=True)[0]
        return rmse_probe

    def feature_training_online_prototype(self, ratings_index, ratings,
                                          initialize_cache=True,
                                          initialize_model=True,
                                          verbose=False):
        '''Online training on an explicit rating-chunk (reference
        gradient_descent.py:358-409) — funk engine on the given chunk.'''
        self._init_factors(initialize_model, sequential=True)
        chunk = (ratings_index[:, 0].astype(np.int32),
                 ratings_index[:, 1].astype(np.int32),
                 np.asarray(ratings, np.float32))
        self._run_funk('none', verbose=verbose, ratings=chunk)

    # --------------------------------------------------- numpy prototypes
    def feature_training_prototype(self, verbose=False, randomize=False):
        '''Pure-numpy oracle of the funk loop (kept, as in the reference, as
        a slow dev twin — gradient_descent.py:214-257).'''
        from mfrec_tpu.ops.reference_numpy import funk_train_oracle
        idx, vals = self.get_ratings(randomize_order=False)
        U = np.full((self.dimensionality, self.nbr_items), self.feature_init)
        V = np.full((self.dimensionality, self.nbr_users), self.feature_init)
        funk_train_oracle(self.min_epochs, self.max_epochs,
                          self.min_improvement, self.dimensionality,
                          self.feature_init, self.learning_rate, self.K,
                          U, V, idx, vals, bias_mode='none')
        self.svd_u, self.svd_v = U, V

    def feature_training_prototype_p(self, verbose=False, randomize=False,
                                     nbr_batch=2):
        '''Zinkevich parameter-averaged parallel SGD (reference
        gradient_descent.py:124-211).  The production multi-chip version is
        ``mfrec_tpu.parallel.dsgd``; this prototype simulates the shards in
        one process like the reference does.'''
        idx, vals = self.get_ratings(randomize_order=False)
        n = idx.shape[0]
        cuts = np.linspace(0, n, nbr_batch + 1).astype(int)
        self._init_factors(True, sequential=True)    # funk per shard
        k = self.dimensionality
        shards_P = []
        shards_Q = []
        for b in range(nbr_batch):
            sl = slice(cuts[b], cuts[b + 1])
            chunk = (idx[sl, 0].astype(np.int32), idx[sl, 1].astype(np.int32),
                     vals[sl].astype(np.float32))
            model = GDRecommender.__new__(GDRecommender)
            model.__dict__.update(self.__dict__)
            model.P, model.Q = self.P.copy(), self.Q.copy()
            model._run_funk('none', verbose=verbose, ratings=chunk)
            shards_P.append(model.P)
            shards_Q.append(model.Q)
        self.P = np.mean(shards_P, axis=0)
        self.Q = np.mean(shards_Q, axis=0)

    # ---------------------------------------------------------- predictors
    def estimate_rating(self, feature_index, user_index, f, cache=False,
                        trailing=False):
        '''Single-feature cached estimator (reference
        gradient_descent.py:602-618).'''
        s = cache if (cache and cache > 0) else 1.0
        s += float(self.Q[feature_index, f] * self.P[user_index, f])
        s = self.clamping(s, self.min_rating, self.max_rating)
        if trailing:
            s += ((self.dimensionality - f - 1)
                  * self.feature_init * self.feature_init)
            s = self.clamping(s, self.min_rating, self.max_rating)
        return s

    def predict_rating(self, item_index, user_index):
        '''dot + 1.0 baseline (reference gradient_descent.py:621-631).'''
        return float(self.Q[item_index] @ self.P[user_index] + 1.0)

    predict = predict_rating

    def predict_rating_with_bias(self, item_index, user_index):
        '''dot + mu + b_i + b_u (reference gradient_descent.py:637-648).'''
        return float(self.Q[item_index] @ self.P[user_index]
                     + self.overall_bias + self.items_bias[item_index]
                     + self.users_bias[user_index])

    def predict_rating_implicit(self, item_index, user_index):
        '''SVD++ predictor with feedback-sum user vector
        (reference gradient_descent.py:651-667).'''
        seek, span = self.feedback_hash[user_index]
        if span <= 0:
            return self.predict_rating_with_bias(item_index, user_index)
        items_id = self.feedback_rated[seek:seek + span, 1]
        p_u = self.P[user_index] + self.Y[items_id].sum(0) / np.sqrt(span)
        return float(self.Q[item_index] @ p_u + self.overall_bias
                     + self.items_bias[item_index]
                     + self.users_bias[user_index])

    def predict_rating_by_label(self, user_label, item_label):
        try:
            item_index = self.items.index[item_label]
            user_index = self.users.index[user_label]
            return self.predict_rating(item_index, user_index)
        except KeyError:
            return self.baseline_predictor(user_label, item_label)

    def predict_batch(self, item_indices, user_indices,
                      predictor='predict_rating'):
        '''Vectorized pairwise prediction (the eval hot path; the reference
        calls the scalar predictor in a python loop, metrics.py:58-66).'''
        dots = (self.Q[np.asarray(item_indices)]
                * self.P[np.asarray(user_indices)]).sum(-1)
        if predictor in ('predict_rating', 'predict'):
            return dots + 1.0
        if predictor == 'predict_rating_with_bias':
            return (dots + self.overall_bias
                    + self.items_bias[np.asarray(item_indices)]
                    + self.users_bias[np.asarray(user_indices)])
        raise KeyError(predictor)

    # --------------------------------------------------------------- fold-in
    def folding_in_new_user(self, label, ratings):
        '''Project a ratings vector onto the item factors
        (reference gradient_descent.py:412-428).'''
        Qt = self.svd_u.T          # [items, dim] in reference orientation
        return np.asarray(ratings) @ Qt / (np.linalg.norm(Qt) ** 2)

    def folding_in_new_item(self, label, ratings):
        Pt = self.svd_v.T
        return np.asarray(ratings) @ Pt / (np.linalg.norm(Pt) ** 2)

    def retrain_user(self, user_index, ratings_index, ratings, verbose=False):
        '''Fold-in retrain: random re-init then masked SGD touching only
        user rows (reference gradient_descent.py:879-891 ->
        estimator_loop_with_bias_dev update_users=1, update_items=0).'''
        valid = np.where(ratings_index[:, 0] == user_index)[0]
        self.init_user_features(user_index)
        self._ensure_bias_arrays()
        chunk = (ratings_index[valid, 0].astype(np.int32),
                 ratings_index[valid, 1].astype(np.int32),
                 np.asarray(ratings, np.float32)[valid])
        self._run_funk('fixed', verbose=verbose, update_items=False,
                       ratings=chunk)

    def retrain_item(self, item_index, ratings_index, ratings, verbose=False):
        valid = np.where(ratings_index[:, 1] == item_index)[0]
        self.init_item_features(item_index)
        self._ensure_bias_arrays()
        chunk = (ratings_index[valid, 0].astype(np.int32),
                 ratings_index[valid, 1].astype(np.int32),
                 np.asarray(ratings, np.float32)[valid])
        self._run_funk('fixed', verbose=verbose, update_users=False,
                       ratings=chunk)

    def _ensure_bias_arrays(self):
        if self.overall_bias is None:
            self.compute_overall_avg()
        if self.items_bias is None or self.users_bias is None:
            self.initialize_bias()
        if self.items_bias.shape[0] < self.nbr_items:
            self.items_bias = np.pad(
                self.items_bias, (0, self.nbr_items
                                  - self.items_bias.shape[0]))
        if self.users_bias.shape[0] < self.nbr_users:
            self.users_bias = np.pad(
                self.users_bias, (0, self.nbr_users
                                  - self.users_bias.shape[0]))

    def add_user(self, user_label, users_ratings_index, users_ratings):
        '''Add + fold-in a new user without touching the training matrix
        (reference gradient_descent.py:908-930).'''
        users_ratings_index = np.asarray(users_ratings_index)
        users_ratings = np.asarray(users_ratings, np.float32)
        if users_ratings_index.shape[0] != users_ratings.shape[0]:
            raise Error('The index and the ratings array must be the same size')
        new_id = self.users.add(user_label)
        self.ratings.grow(nbr_users=new_id + 1)
        self.P = np.resize(self.P, (new_id + 1, self.dimensionality))
        ratings_index = np.zeros((users_ratings.shape[0], 2), np.int32)
        ratings_index[:, 0] = new_id
        ratings_index[:, 1] = users_ratings_index
        self.retrain_user(new_id, ratings_index, users_ratings)
        return new_id

    def add_item(self, item_label, items_ratings_index, items_ratings):
        items_ratings_index = np.asarray(items_ratings_index)
        items_ratings = np.asarray(items_ratings, np.float32)
        if items_ratings_index.shape[0] != items_ratings.shape[0]:
            raise Error('The index and the ratings array must be the same size')
        new_id = self.items.add(item_label)
        self.ratings.grow(nbr_items=new_id + 1)
        self.Q = np.resize(self.Q, (new_id + 1, self.dimensionality))
        ratings_index = np.zeros((items_ratings.shape[0], 2), np.int32)
        ratings_index[:, 1] = new_id
        ratings_index[:, 0] = items_ratings_index
        self.retrain_item(new_id, ratings_index, items_ratings)
        return new_id

    # ------------------------------------------------------ GD similarity
    def _cosine_similarity_binary(self, A_set, B_set):
        count = len(A_set.intersection(B_set))
        denom = np.sqrt(float(len(A_set) * len(B_set)))
        return float(count) / denom if denom else 0.0

    def similar_users(self, user_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='cosine_binary'):
        '''GD override: binary rated-set cosine by default (reference
        gradient_descent.py:712-766), one matmul on device.

        NOTE: densifies the ratings indicator ([U, I]) — fine at ML-100K
        scale; for large catalogs use a factor-space method
        (method='cosine'/'pearson').'''
        if method != 'cosine_binary':
            return MFRecommender.similar_users(
                self, user_index, nbr_recommendations, similarity_threshold,
                similarities_output, method)
        B = jnp.asarray(self.ratings.to_dense() != 0, jnp.float32)
        n = B.shape[0]
        nbr = nbr_recommendations
        if nbr == 'All':
            nbr = n - 1
        idx, sims = sim_ops.binary_cosine_topk(
            B, jnp.asarray([int(user_index)]), min(int(nbr), n - 1))
        ids = np.asarray(idx[0])
        vals = np.asarray(sims[0], np.float64)
        ids, vals = self._apply_threshold(ids, vals, similarity_threshold)
        if not similarities_output:
            return [int(x) for x in ids]
        return [int(x) for x in ids], [float(v) for v in vals]

    def compute_components_mean(self):
        self.components_mean = np.asarray(self.Q).mean(axis=0)

    def _normalize_cosine_similarity(self, A, B):
        '''Component-mean-centered log-cosine (reference
        gradient_descent.py:814-824).'''
        An = np.asarray(A) - self.components_mean[1:self.dimensionality]
        Bn = np.asarray(B) - self.components_mean[1:self.dimensionality]
        ip = float(An @ Bn)
        if ip == 0:
            return 0.0
        return float(np.log(1.0 + ip / (np.linalg.norm(An)
                                        * np.linalg.norm(Bn))))

    def similar_items(self, item_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='pearson'):
        '''GD override: similarity over factor components 1..dim (component
        0 excluded) with pearson default (reference
        gradient_descent.py:827-875).'''
        F = np.asarray(self.Q, np.float32)[:, 1:self.dimensionality]
        if method == 'norm_cosine':
            self.compute_components_mean()
            F = F - self.components_mean[None, 1:self.dimensionality]
            method = 'cosine_log'
        return self._similar_topk(F, int(item_index), nbr_recommendations,
                                  similarity_threshold, similarities_output,
                                  method)

    def find_user_top_match(self, user_index, nbr_recommendations=5):
        '''GD override: score all items with the dot predictor
        (reference gradient_descent.py:769-802) — fused top-N kernel.'''
        ids, scores = self.find_recommended_items(
            user_index=user_index, nbr_recommendations=nbr_recommendations,
            predictor='predict_rating')
        return ids, scores
