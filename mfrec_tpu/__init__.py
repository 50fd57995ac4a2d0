'''
mfrec_tpu — a latent-factor recommender framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capability surface of the
reference library ``mlaprise/mfrec``:

* Funk/BellKor SGD matrix factorization with no/fixed/learned biases and
  SVD++-style implicit feedback (reference: ``mfrec/lib/gd_estimator.pyx``,
  ``mfrec/recommendation/gradient_descent.py``),
* implicit-feedback weighted ALS / WRMF (reference:
  ``mfrec/lib/als_implicit.pyx``, ``mfrec/recommendation/wrmf.py``),
* kernel MF with logistic/linear kernels (reference:
  ``mfrec/lib/kmf_train.pyx``, ``mfrec/recommendation/kmf.py``),
* truncated SVD + SVD/kNN hybrids, user-kNN, popularity/random baselines,
* top-N retrieval, item/user similarity + graph export, fold-in of new
  users/items, checkpointing, RMSE/MAE/P@N evaluation.

The compute path is idiomatic JAX: batched/blocked XLA programs,
``shard_map`` + collectives over a device mesh for scale, and a Pallas
kernel (Triton route, NVIDIA GPUs) for the alternating engine's inner
sweeps.  Host-side preprocessing has a native C++ fast path
(``mfrec_tpu/native``).
'''

__version__ = '0.1.0'

from mfrec_tpu.models.base import BaseRecommender, Error, LinearModel
from mfrec_tpu.models.mf import MFRecommender
from mfrec_tpu.models.gd import GDRecommender
from mfrec_tpu.models.wrmf import WRMFRecommender
from mfrec_tpu.models.kmf import KMFRecommender
from mfrec_tpu.models.fn import FNRecommender
from mfrec_tpu.models.svd import SVDRecommender
from mfrec_tpu.models.knn_svd import KNNSVDRecommender
from mfrec_tpu.models.knn_users import KNNUsersRecommender
from mfrec_tpu.models.popular import MostPopularRecommender
from mfrec_tpu.models.random_ import RandomRecommender

__all__ = [
    'BaseRecommender', 'Error', 'LinearModel', 'MFRecommender',
    'GDRecommender',
    'WRMFRecommender', 'KMFRecommender', 'FNRecommender', 'SVDRecommender',
    'KNNSVDRecommender', 'KNNUsersRecommender', 'MostPopularRecommender',
    'RandomRecommender',
]
