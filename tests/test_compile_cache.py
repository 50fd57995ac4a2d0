'''The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise one fixed directory inside the checkout.'''
import os

import jax
import pytest

from mfrec_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', before)


def test_env_dir_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_cache_config):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(compile_cache.__file__))))
    assert path == os.path.join(root, '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == path


def test_path_is_stable_across_calls(monkeypatch, restore_cache_config):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert (compile_cache.enable_compile_cache()
            == compile_cache.enable_compile_cache()
            == compile_cache.CHECKOUT_CACHE_DIR)
