"""The compile-cache rule (cli/main.compile_cache_dir): JAX_COMPILATION_
CACHE_DIR when set, and then nothing set in code; otherwise the fixed path
<checkout>/.jax_cache."""

import os

import jax

from cvsim_tpu.cli import main as climain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_variable_set_means_no_dir_from_code():
    assert climain.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_variable_unset_means_checkout_dir():
    assert climain.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    # an empty value counts as unset
    assert climain.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == os.path.join(REPO, ".jax_cache")


def test_enable_sets_config_only_without_the_variable(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    climain.enable_compile_cache()
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    climain.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(REPO, ".jax_cache"))]
