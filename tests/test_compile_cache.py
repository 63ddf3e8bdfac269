"""The persistent compile cache helper: JAX's own setting when
JAX_COMPILATION_CACHE_DIR is set, the fixed <repo>/.jax_cache
otherwise."""

import pathlib

import jax
import pytest

from rrtmg_lw_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_repo_dir_without_env(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cc.enable_compile_cache()
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert path == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
