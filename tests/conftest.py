'''Test harness: force an 8-device virtual CPU mesh before jax imports,
so multi-device sharding logic is exercised without accelerators (the
analogue of the reference's "Machine 1 / Machine 2 in one process"
simulation).  Tests that need a GPU carry the ``gpu`` marker and skip
here; ``chip_smoke.py`` runs their checks on the card.'''
import os

# jax may already be imported with another platform
# preset, so besides the env var the config is overridden directly.
os.environ['JAX_PLATFORMS'] = 'cpu'
_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()

import jax
jax.config.update('jax_platforms', 'cpu')

import numpy as np
import pytest

from mfrec_tpu.data.movielens import synthetic_ratings, train_test_split


@pytest.fixture(scope='session')
def small_dataset():
    '''~6k synthetic ratings, 300 users x 200 items, planted rank-6.'''
    users, items, values = synthetic_ratings(
        nbr_users=300, nbr_items=200, nbr_ratings=6000, rank=6, seed=1)
    return train_test_split(users, items, values, test_fraction=0.2, seed=2)


@pytest.fixture(scope='session')
def tiny_dataset():
    '''~800 ratings, 60 users x 40 items — for serial-oracle parity.'''
    users, items, values = synthetic_ratings(
        nbr_users=60, nbr_items=40, nbr_ratings=800, rank=4, seed=3)
    return train_test_split(users, items, values, test_fraction=0.2, seed=4)
