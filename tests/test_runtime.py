"""utils/runtime.py: the one backend decision and the compile cache."""

import jax
import pytest

from expann_tpu.utils import runtime


@pytest.mark.parametrize(
    "platform,interpret", [("gpu", False), ("cpu", True), ("metal", None)]
)
def test_pallas_interpret_per_platform(monkeypatch, platform, interpret):
    monkeypatch.setattr(runtime, "platform", lambda: platform)
    if interpret is None:
        with pytest.raises(RuntimeError, match="no Pallas kernel path"):
            runtime.pallas_interpret()
    else:
        assert runtime.pallas_interpret() is interpret


@pytest.fixture
def fresh_configure(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(runtime, "_configured", False)
    monkeypatch.delenv("EXPANN_NO_CACHE", raising=False)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_configure_uses_repo_cache_without_env(monkeypatch, fresh_configure):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    runtime.configure()
    assert jax.config.jax_compilation_cache_dir == runtime.REPO_CACHE_DIR
    assert runtime.REPO_CACHE_DIR.endswith(".jax_cache")


def test_configure_leaves_env_cache_dir(monkeypatch, tmp_path, fresh_configure):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    runtime.configure()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
