'''
Persistent compile cache for the program's entry points.

``enable_compile_cache()`` is called by the scripts a user runs
(``chip_smoke.py``, ``bench.py``, the examples) — never by an import of
the package.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
reads it and nothing is set here; otherwise the cache goes to one fixed
directory inside the checkout, ``<checkout>/.jax_cache`` (the path is
part of the cache key, so it never depends on a temp name, a pid or the
time).
'''
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def enable_compile_cache():
    '''Point JAX's persistent compile cache at its directory and return
    that directory.'''
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
