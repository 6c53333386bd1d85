"""config.use_compile_cache: the persistent compile cache's location."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from quantpy_tpu import config

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_sets_nothing(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.use_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the path is fixed: a second call returns the same directory
    assert config.use_compile_cache() == path


def test_import_sets_no_cache_dir():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, "-c",
         "import jax, quantpy_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "None"
