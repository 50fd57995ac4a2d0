'''
SVDRecommender — truncated sparse SVD recommender.

Re-design of reference ``mfrec/recommendation/simplesvd.py:18-115``: user
mean-centering, truncated SVD of the [users, items] matrix (the randomized
SVD kernel replaces third-party ``sparsesvd``), prediction by projecting
the user's rating row through the item subspace: r_u . V . v_i^T.

Factor orientation note: this class follows simplesvd.py (SVD of the
*untransposed* matrix): svd_u = user side [dim, users], svd_v = item side
[dim, items] — the opposite of base.py's convention.  Internally
self.P = user factors [users, k], self.Q = V^T columns [items, k].
'''
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.ops import svd as svd_ops
from mfrec_tpu.ops import similarity as sim_ops


class SVDRecommender(MFRecommender):
    '''Simple SVD Recommendation Engine.'''

    PARAMETERS_INDEX = {'nbr_features': 'dimensionality'}

    # predict() projects the rating row through the item subspace — not a
    # factor dot product — so top-N must score through the host predictor
    _default_predictor_mode = None

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False):
        MFRecommender.__init__(self, nbr_users, nbr_items, None)
        self.dimensionality = 150          # reference default simplesvd.py:40
        if parameters:
            self.set_parameters(parameters)

    @property
    def svd_full_s(self):
        return np.diag(self.svd_s)

    def _compute_svd(self, normalize_data=True):
        '''SVD of [users, items] (reference simplesvd.py:75-82).'''
        if normalize_data:
            self.data_normalization()
        u, i, v = self.ratings.coo()
        k = min(self.dimensionality, self.nbr_users, self.nbr_items)
        U, s, Vt = svd_ops.randomized_svd(
            jnp.asarray(u), jnp.asarray(i), jnp.asarray(v),
            self.nbr_users, self.nbr_items, k)
        self.P = np.array(U)               # [users, k] — svd_u in ref naming
        self.svd_s = np.array(s)
        self.Q = np.array(Vt).T            # [items, k] — svd_v in ref naming

    def train(self):
        self._compute_svd(normalize_data=True)

    def predict(self, item_index, user_index):
        '''Project the user's rating row through the item subspace
        (reference simplesvd.py:58-64): (r_u @ V) @ v_i.'''
        ptr, items, vals = self.ratings.csr()
        s, e = ptr[user_index], ptr[user_index + 1]
        a = vals[s:e] @ self.Q[items[s:e]]            # [k]
        b = float(a @ self.Q[item_index])
        if self.data_normalized:
            b = b + self.users_bias[user_index]
        return b

    def _score_unrated_host(self, user_index, predictor):
        '''All items at once: (r_u @ V) @ V^T is one [k] projection plus
        one [I, k] @ [k] matvec — numerically the same
        arithmetic as the per-item ``predict`` loop.'''
        if predictor != 'predict':
            return None
        ptr, items, vals = self.ratings.csr()
        s, e = ptr[user_index], ptr[user_index + 1]
        a = vals[s:e] @ self.Q[items[s:e]]            # [k]
        scores = self.Q @ a                           # [I]
        if self.data_normalized:
            scores = scores + self.users_bias[user_index]
        return scores

    def predict_batch(self, item_indices, user_indices, predictor='predict'):
        if predictor != 'predict':
            raise KeyError(predictor)
        ptr, items, vals = self.ratings.csr()
        out = np.zeros(len(item_indices))
        proj_cache = {}
        for j, (i, u) in enumerate(zip(np.asarray(item_indices),
                                       np.asarray(user_indices))):
            if u not in proj_cache:
                s, e = ptr[u], ptr[u + 1]
                proj_cache[u] = vals[s:e] @ self.Q[items[s:e]]
            out[j] = proj_cache[u] @ self.Q[i]
        if self.data_normalized:
            out = out + self.users_bias[np.asarray(user_indices)]
        return out

    # Similarity caches over this class's factor orientation
    # (reference simplesvd.py:85-113)
    def _compute_items_similarities(self, k):
        F = jnp.asarray(self.Q, jnp.float32)
        idx, sims = sim_ops.all_pairs_topk(F, min(k, F.shape[0] - 1),
                                           method='cosine')
        self.items_similarities_sorted_id = np.asarray(idx)
        self.items_similarities_values = np.asarray(sims)

    def _compute_users_similarities(self, k, method='cosine'):
        F = jnp.asarray(self.P, jnp.float32)
        idx, sims = sim_ops.all_pairs_topk(F, min(k, F.shape[0] - 1),
                                           method=method)
        self.users_similarities_sorted_id = np.asarray(idx)
        self.users_similarities_values = np.asarray(sims)
