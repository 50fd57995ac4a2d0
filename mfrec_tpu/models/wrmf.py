'''
WRMFRecommender — implicit-feedback weighted ALS.

Re-design of reference ``mfrec/recommendation/wrmf.py:20-110`` over the
batched-Cholesky ALS kernel (``ops.als``), replacing the per-row
``np.linalg.inv``-in-a-loop of ``als_implicit.pyx:211-352``.

Hu, Koren, Volinsky: Collaborative Filtering for Implicit Feedback
Datasets, ICDM 2008.
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.ops import als as als_ops


class WRMFRecommender(MFRecommender):
    '''Weighted Regularized Matrix Factorization Recommendation Engine.'''

    PARAMETERS_INDEX = {'nbr_epochs': 'nbr_epochs',
                        'feature_init': 'feature_init',
                        'regularization_model': 'K',
                        'neighborhood': 'neighborhood',
                        'nbr_features': 'dimensionality',
                        'c_pos': 'c_pos',
                        'alpha': 'alpha',
                        'gram_dtype': 'gram_dtype',
                        'solver': 'solver',
                        'cg_steps': 'cg_steps',
                        'cg_warm_steps': 'cg_warm_steps',
                        'cg_warmup_epochs': 'cg_warmup_epochs',
                        'engine': 'engine',
                        'init_mode': 'init_mode'}

    _default_predictor_mode = 'dot'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None):
        MFRecommender.__init__(self, nbr_users, nbr_items, None)

        # Reference defaults (wrmf.py:39-43)
        self.nbr_epochs = 20
        self.feature_init = 0.1
        self.K = 0.025
        self.dimensionality = 20
        self.neighborhood = 500
        # Confidence weighting: reference hardcodes c_pos=1, reg k=0.015 at
        # the call site and ignores self.K (wrmf.py:110 — latent defect).
        # Here self.K is honored; c_pos keeps the reference default and
        # alpha>0 switches to rating-scaled confidence c_ui = 1 + alpha*r.
        self.c_pos = 1.0
        self.alpha = 0.0
        # 'bfloat16' runs the rank-L Gram corrections with bf16 inputs
        # and f32 accumulation (the k x k solves stay f32);
        # None keeps everything f32 (the oracle-parity setting).
        self.gram_dtype = None
        # solver='cg': warm-started matrix-free CG half-sweeps (fast
        # path, ~same fixed point); 'exact' = batched Cholesky (oracle
        # parity).  cg_steps: CG iterations per half-sweep.
        self.solver = 'exact'
        self.cg_steps = 6
        # After cg_warmup_epochs, drop to cg_warm_steps CG iterations per
        # half-sweep (warm starts make late epochs cheap; None = no drop).
        self.cg_warm_steps = None
        self.cg_warmup_epochs = 2
        # engine='auto': single-chip nnz-bucket ALS on one device, the
        # mesh-sharded epoch (parallel.als_sharded) on >1; 'als' /
        # 'als_sharded' force either path.
        self.engine = 'auto'
        # init_mode='normal' (default): N(0, feature_init) factor init.
        # The reference's constant f_init (wrmf.py:92-93) is a latent
        # defect: with every column identical, the ALS normal equations
        # are permutation-symmetric, so columns stay identical FOREVER —
        # the model is rank-1 regardless of nbr_features (only float
        # rounding slowly breaks the tie).  'constant' keeps the
        # reference behavior for parity runs.
        self.init_mode = 'normal'

        if parameters:
            self.set_parameters(parameters)

    def predict(self, item_index, user_index):
        '''Plain dot product (reference wrmf.py:67-69).'''
        return float(self.Q[item_index] @ self.P[user_index])

    def predict_batch(self, item_indices, user_indices, predictor='predict'):
        return (self.Q[np.asarray(item_indices)]
                * self.P[np.asarray(user_indices)]).sum(-1)

    def predict_rating_by_label(self, user_label, item_label):
        try:
            return self.predict(self.items.index[item_label],
                                self.users.index[user_label])
        except KeyError:
            return 0.0

    def train(self, initialize_model=True, handle_bias=False, verbose=False):
        '''ALS training (reference wrmf.py:83-110): binarized implicit
        preferences, alternating batched normal-equation solves.'''
        if initialize_model or self.P is None:
            if self.init_mode == 'normal':
                self.P = self.rng.normal(
                    0.0, self.feature_init,
                    (self.nbr_users, self.dimensionality)).astype(np.float32)
                self.Q = self.rng.normal(
                    0.0, self.feature_init,
                    (self.nbr_items, self.dimensionality)).astype(np.float32)
            else:        # 'constant': reference-faithful (see __init__)
                self.P = np.full((self.nbr_users, self.dimensionality),
                                 self.feature_init, np.float32)
                self.Q = np.full((self.nbr_items, self.dimensionality),
                                 self.feature_init, np.float32)

        self.initialize_rated_feedback()
        self.compute_overall_avg()

        import jax
        engine = self.engine
        if engine == 'auto':
            engine = 'als_sharded' if len(jax.devices()) > 1 else 'als'
        if engine == 'als_sharded':
            return self._train_sharded(verbose=verbose)
        if engine != 'als':
            from mfrec_tpu.models.base import Error
            raise Error('unknown engine %r' % (self.engine,))

        user_buckets = self.ratings.padded_rows(axis='user')
        item_buckets = self.ratings.padded_rows(axis='item')

        P, Q = als_ops.als_wrmf_train(
            jnp.asarray(self.P, jnp.float32),
            jnp.asarray(self.Q, jnp.float32),
            user_buckets, item_buckets,
            nbr_epochs=int(self.nbr_epochs),
            c_pos=float(self.c_pos), alpha=float(self.alpha),
            reg=float(self.K),
            gram_dtype=jnp.bfloat16 if self.gram_dtype == 'bfloat16'
            else None,
            solver=self.solver, cg_steps=int(self.cg_steps),
            cg_warm_steps=(None if self.cg_warm_steps is None
                           else int(self.cg_warm_steps)),
            cg_warmup_epochs=int(self.cg_warmup_epochs),
            callback=(lambda e, P, Q: self.logger.info('Epoch : %d', e))
            if verbose else None)
        self.P = np.array(P)
        self.Q = np.array(Q)
        # Rows with no ratings solve to M^-1 @ 0 = 0 in the reference
        # (als_implicit.pyx:296-302); padded buckets skip them, so zero here.
        self.P[self.ratings.user_counts() == 0] = 0.0
        self.Q[self.ratings.item_counts() == 0] = 0.0

    def _train_sharded(self, verbose=False, n_devices=None):
        '''Mesh-sharded ALS (``parallel.als_sharded``): factors
        row-sharded over the device mesh, one all_gather of the fixed
        side per half-sweep; honors the same solver/cg/gram knobs as the
        single-chip path.'''
        import jax
        from mfrec_tpu.parallel import als_sharded
        from mfrec_tpu.parallel.mesh import make_mesh
        D = n_devices or len(jax.devices())
        mesh = make_mesh(D)
        u_idx, u_val, u_mask = als_sharded.padded_uniform(
            self.ratings, 'user', D)
        i_idx, i_val, i_mask = als_sharded.padded_uniform(
            self.ratings, 'item', D)
        solver = self.solver
        epoch = als_sharded.make_sharded_als_epoch(
            mesh, c_pos=float(self.c_pos), alpha=float(self.alpha),
            reg=float(self.K), solver=solver, cg_steps=int(self.cg_steps),
            gram_dtype=jnp.bfloat16 if self.gram_dtype == 'bfloat16'
            else None)
        warm_epoch = None
        if solver == 'cg' and self.cg_warm_steps is not None \
                and int(self.cg_warm_steps) != int(self.cg_steps):
            warm_epoch = als_sharded.make_sharded_als_epoch(
                mesh, c_pos=float(self.c_pos), alpha=float(self.alpha),
                reg=float(self.K), solver='cg',
                cg_steps=int(self.cg_warm_steps))
        Ru, Ri = u_idx.shape[0], i_idx.shape[0]
        P = jnp.asarray(np.pad(np.asarray(self.P, np.float32),
                               ((0, Ru - self.nbr_users), (0, 0))))
        Q = jnp.asarray(np.pad(np.asarray(self.Q, np.float32),
                               ((0, Ri - self.nbr_items), (0, 0))))
        u_idx, u_val, u_mask, i_idx, i_val, i_mask = (
            jnp.asarray(x) for x in
            (u_idx, u_val, u_mask, i_idx, i_val, i_mask))
        for e in range(int(self.nbr_epochs)):
            fn = epoch if (warm_epoch is None
                           or e < int(self.cg_warmup_epochs)) else warm_epoch
            P, Q = fn(P, Q, u_idx, u_val, u_mask, i_idx, i_val, i_mask)
            if verbose:
                self.logger.info('Epoch : %d', e)
        self.P = np.array(P)[:self.nbr_users]
        self.Q = np.array(Q)[:self.nbr_items]
        self.P[self.ratings.user_counts() == 0] = 0.0
        self.Q[self.ratings.item_counts() == 0] = 0.0
