'''
Device-mesh helpers.

The reference has no operational parallelism — its only artifact is a
single-process simulation of parameter-averaged SGD
(``gradient_descent.py:124-211``).  Here the scaling substrate is a
``jax.sharding.Mesh`` with XLA collectives; these helpers build meshes
and shardings.  A mesh follows the algorithm, not a link topology: the
devices of one host reach each other all to all.
'''
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis_name='dp'):
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(n_slices, per_slice, axis_names=('slice', 'dp')):
    '''[n_slices, per_slice] mesh for multi-slice training: each slice
    (leading axis) trains its own shard of the ratings against its own
    factor replica, and the replicas are parameter-averaged once per
    epoch (one pmean over this axis); within a slice (trailing axis) the
    factor rows are sharded and the half-passes all_gather them.'''
    devices = jax.devices()[:n_slices * per_slice]
    if len(devices) < n_slices * per_slice:
        raise ValueError('need %d devices, have %d'
                         % (n_slices * per_slice, len(devices)))
    return Mesh(np.asarray(devices).reshape(n_slices, per_slice),
                axis_names)


def row_sharding(mesh, axis_name='dp'):
    '''Shard a [n, ...] array along rows.'''
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh):
    return NamedSharding(mesh, P())


def pad_rows_to_multiple(x, multiple, fill=0):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width, constant_values=fill)
