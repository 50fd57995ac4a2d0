'''
MFRecommender — the matrix-factorization common layer.

Re-design of reference ``mfrec/recommendation/mf.py:33-194``: clamping,
BellKor regularized bias estimates, random-normal factor init, and top-N
recommendation.  Top-N is a fused blocked P@Q^T + top_k device kernel
instead of the reference's per-candidate python loop (mf.py:144-193).
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.base import BaseRecommender, Error
from mfrec_tpu.ops import topk as topk_ops


class MFRecommender(BaseRecommender):
    '''Base class for the matrix factorization based recommenders.'''

    # predictor name -> topn_scores kernel mode
    _PREDICTOR_MODES = {
        'predict': None,             # resolved per class
        'predict_rating': 'dot_plus_one',
        'predict_rating_with_bias': 'bias',
        'predict_logistic': 'logistic',
        'predict_linear': 'bias',
    }

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None):
        BaseRecommender.__init__(self, nbr_users, nbr_items, parameters)
        self.neighborhood = 500

    # ------------------------------------------------------------- helpers
    def _alternating_layouts(self, max_window):
        '''Device-resident sorted-pass layouts for the alternating tiers,
        cached on the ratings snapshot ``version`` (+ batch/window).

        The layout build is O(nnz) host work (two counting sorts + window
        assignment) followed by an O(nnz) device upload; without the
        cache every ``train()`` call —
        sweeps, retrains, the plateau-decay e2e drive — re-paid both even
        though the ratings had not changed.  Shared by the GD and
        KMF alternating engines.'''
        from mfrec_tpu.ops import sgd_mf
        key = (self.ratings.version, self.ratings.nnz, self.batch_size,
               max_window)
        cached = getattr(self, '_alt_layout_cache', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        uidx, iidx, vals = self.ratings.coo()
        pl_ = sgd_mf.sorted_pass_layout(uidx, iidx, vals, self.batch_size,
                                        axis='user', max_window=max_window)
        ql_ = sgd_mf.sorted_pass_layout(uidx, iidx, vals, self.batch_size,
                                        axis='item', max_window=max_window)
        W_user, W_item = pl_[-1], ql_[-1]
        p_layout = tuple(jnp.asarray(x) for x in pl_[:-1])
        q_layout = tuple(jnp.asarray(x) for x in ql_[:-1])
        out = (p_layout, q_layout, W_user, W_item)
        self._alt_layout_cache = (key, out)
        return out

    def clamping(self, value, min=1.0, max=5.0):
        '''Clamp to [min, max].  (The reference hardcodes [1, 5] and ignores
        its arguments — mf.py:44-53, a latent defect not replicated.)'''
        return float(np.clip(value, min, max))

    def warmyup(self):
        '''Kept for API parity (reference mf.py:64-65); CSC/CSR recasts are
        cached inside the Ratings store here.'''
        self.ratings.csc()

    def init_feature_normal(self, mean=0.0, std=0.1):
        '''Random-normal factor init (reference mf.py:124-133).'''
        k = self.dimensionality
        self.Q = self.rng.normal(mean, std,
                                 (self.nbr_items, k)).astype(np.float32)
        self.P = self.rng.normal(mean, std,
                                 (self.nbr_users, k)).astype(np.float32)

    def init_user_features(self, user_index, mean=0.0, std=0.1):
        self.P[user_index] = self.rng.normal(
            mean, std, self.dimensionality).astype(np.float32)

    def init_item_features(self, item_index, mean=0.0, std=0.1):
        self.Q[item_index] = self.rng.normal(
            mean, std, self.dimensionality).astype(np.float32)

    # -------------------------------------------------------------- biases
    def compute_items_bias_bk(self):
        '''Regularized item bias, BellKor shrinkage sum/(K3+N)
        (reference mf.py:78-97).'''
        if not self.overall_bias:
            self.compute_overall_avg()
        u, i, v = self.ratings.coo()
        counts = self.ratings.item_counts()
        dev = np.bincount(i, weights=v - self.overall_bias,
                          minlength=self.nbr_items)
        K3 = getattr(self, 'K3', 0.01)
        with np.errstate(invalid='ignore'):
            bias = dev / (K3 + counts)
        bias[counts == 0] = 0.0
        self.items_bias = np.nan_to_num(bias).astype(np.float32)

    def compute_users_bias_bk(self):
        '''Regularized user bias over item-bias-adjusted residuals
        (reference mf.py:100-121).'''
        if not self.overall_bias:
            self.compute_overall_avg()
        if self.items_bias is None:
            self.compute_items_bias_bk()
        u, i, v = self.ratings.coo()
        counts = self.ratings.user_counts()
        resid = v - self.overall_bias - self.items_bias[i]
        dev = np.bincount(u, weights=resid, minlength=self.nbr_users)
        K2 = getattr(self, 'K2', 0.01)
        with np.errstate(invalid='ignore'):
            bias = dev / (K2 + counts)
        bias[counts == 0] = 0.0
        self.users_bias = np.nan_to_num(bias).astype(np.float32)

    # ---------------------------------------------------------- prediction
    def predict_rating_by_label(self, user_label, item_label,
                                predictor='predict'):
        try:
            item_index = self.items.index[item_label]
            user_index = self.users.index[user_label]
            return float(getattr(self, predictor)(item_index, user_index))
        except KeyError:
            return self.overall_bias if self.overall_bias else 0.0

    def _predictor_mode(self, predictor):
        mode = self._PREDICTOR_MODES.get(predictor)
        if predictor == 'predict':
            mode = getattr(self, '_default_predictor_mode', 'dot_plus_one')
        return mode

    def find_recommended_items(self, user_index=None, user_label=None,
                               nbr_recommendations=5, output_label=False,
                               predictor='predict', neighborhood=None):
        '''Top-N recommendation for one user.

        By default ALL items are scored in one fused blocked matmul+top_k
        kernel, rated items masked on-device.  Pass ``neighborhood=C`` (or
        ``neighborhood=True`` to use ``self.neighborhood``) to instead
        score a random C-item candidate subset — the reference's behavior
        (mf.py:144-193, via get_items_subset base.py:1134; its latent
        defect of scoring ids 0..neighborhood-1 is not replicated).
        Returns ([ids], [scores]).
        '''
        if user_index is None:
            user_index = self.users.index[user_label]
        mode = self._predictor_mode(predictor)
        if mode is None:
            return self._find_recommended_items_host(
                user_index, nbr_recommendations, output_label, predictor)
        rated_idx, rated_mask = topk_ops.pad_rated_lists(self.ratings,
                                                         [user_index])
        bu = self.users_bias if self.users_bias is not None \
            else np.zeros(self.nbr_users, np.float32)
        bi = self.items_bias if self.items_bias is not None \
            else np.zeros(self.nbr_items, np.float32)
        mu = self.overall_bias if self.overall_bias else 0.0
        Q = np.asarray(self.Q, np.float32)
        cand = None
        if neighborhood:
            C = self.neighborhood if neighborhood is True \
                else int(neighborhood)
            if C < self.nbr_items:
                cand = np.sort(self.rng.choice(self.nbr_items, C,
                                               replace=False))
                Q = Q[cand]
                bi = bi[cand]
                # remap rated ids into candidate-local ids (missing -> mask 0)
                local = np.searchsorted(cand, rated_idx)
                local = np.clip(local, 0, C - 1)
                hit = cand[local] == rated_idx
                rated_mask = rated_mask * hit
                rated_idx = np.where(hit, local, 0).astype(np.int32)
        n = min(int(nbr_recommendations), Q.shape[0])
        idx, scores = topk_ops.topn_scores(
            jnp.asarray(self.P[None, user_index], jnp.float32),
            jnp.asarray(Q),
            jnp.asarray([bu[user_index]], jnp.float32),
            jnp.asarray(bi, jnp.float32), jnp.float32(mu),
            jnp.asarray(rated_idx), jnp.asarray(rated_mask),
            n, predictor=mode,
            lo=self.min_rating, hi=self.max_rating)
        ids = np.asarray(idx[0])
        vals = np.asarray(scores[0], np.float64)
        keep = vals > topk_ops.NEG / 2
        if cand is not None:
            ids = cand[ids]
        return [int(x) if not output_label else self.items.labels[int(x)]
                for x in ids[keep]], [float(v) for v in vals[keep]]

    def _score_unrated_host(self, user_index, predictor):
        '''All-items score vector for predictors with no device
        ``mu+bu+bi+dot`` mapping, vectorized over items — or None to fall
        back to the per-item python loop (SVD's projection is one matmul, KNNSVD's vote one ``_knn_user_votes``
        pass; scoring them pair-by-pair contradicted the batched-serving
        bar).  Rated-item slots may hold anything — the caller zeroes
        them, matching the loop's skip.'''
        return None

    def _find_recommended_items_host(self, user_index, nbr_recommendations,
                                     output_label, predictor):
        '''Fallback for predictors without a device score mapping.'''
        rated = self.ratings.rated_mask_for_user(user_index)
        scores = self._score_unrated_host(user_index, predictor)
        if scores is None:
            # per-pair python loop — only for truly custom predictors
            scores = np.zeros(self.nbr_items)
            fn = getattr(self, predictor)
            for i in range(self.nbr_items):
                if rated[i]:
                    continue
                try:
                    scores[i] = fn(i, user_index)
                except Error:
                    scores[i] = 0.0
        else:
            scores = np.asarray(scores, np.float64).copy()
            scores[np.asarray(rated[:self.nbr_items], bool)] = 0.0
        scores = np.nan_to_num(scores)
        nz = np.nonzero(scores)[0]
        order = nz[np.argsort(-scores[nz], kind='stable')]
        order = order[:nbr_recommendations]
        out = [self.items.labels[int(i)] if output_label else int(i)
               for i in order]
        return out, [float(scores[i]) for i in order]

    def recommend_batch(self, user_indices, nbr_recommendations=5,
                        predictor='predict', sharded=None, mask_rated=True,
                        rated_pad_to=None):
        '''Batched top-N for many users in one device call — the serving
        path (no reference equivalent; the reference loops users).

        ``sharded`` (default: auto when >1 device): run the mesh-sharded
        retrieval (``parallel.topn_sharded`` — Q sharded over the items
        axis, per-shard top-k, all_gather + global re-rank), result-
        identical to the single-device path.'''
        import jax
        users = np.asarray(user_indices)
        bu = self.users_bias if self.users_bias is not None \
            else np.zeros(self.nbr_users, np.float32)
        bi = self.items_bias if self.items_bias is not None \
            else np.zeros(self.nbr_items, np.float32)
        mu = float(self.overall_bias or 0.0)
        n = min(int(nbr_recommendations), self.nbr_items)
        if mask_rated:
            rated_idx, rated_mask = topk_ops.pad_rated_lists(
                self.ratings, users, pad_to=rated_pad_to)
        else:
            rated_idx = np.zeros((len(users), 1), np.int32)
            rated_mask = np.zeros((len(users), 1), np.float32)
        if sharded is None:
            sharded = len(jax.devices()) > 1
        mode = self._predictor_mode(predictor)
        if mode is None:
            # models whose predictor has no mu+bu+bi+dot mapping
            # (SVDRecommender's singular-value scaling, KNNSVD's kNN
            # vote) must score through their own host predictor, like
            # find_recommended_items does — coercing them to
            # dot_plus_one silently mis-ranks (ranking_metrics and the
            # serving view route through here).  Host path; always
            # masks rated items.
            idx = np.zeros((len(users), n), np.int32)
            sc = np.full((len(users), n), topk_ops.NEG, np.float32)
            for row, uu in enumerate(users):
                ids, vals = self.find_recommended_items(
                    user_index=int(uu), nbr_recommendations=n,
                    predictor=predictor)
                idx[row, :len(ids)] = ids[:n]
                sc[row, :len(vals)] = vals[:n]
            return idx, sc
        if sharded:
            from mfrec_tpu.parallel.topn_sharded import sharded_topn
            return sharded_topn(
                self.P[users], self.Q, bu[users], bi, mu,
                rated_idx, rated_mask, n, predictor=mode,
                lo=self.min_rating, hi=self.max_rating)
        idx, scores = topk_ops.topn_scores(
            jnp.asarray(self.P[users], jnp.float32),
            jnp.asarray(self.Q, jnp.float32),
            jnp.asarray(bu[users], jnp.float32),
            jnp.asarray(bi, jnp.float32), jnp.float32(mu),
            jnp.asarray(rated_idx), jnp.asarray(rated_mask),
            n, predictor=mode,
            lo=self.min_rating, hi=self.max_rating)
        return np.asarray(idx), np.asarray(scores)
