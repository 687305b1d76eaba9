"""Guards on settings the GPU build relies on: the compile-cache location
and the precision of every parity path."""

import os

import pytest


def test_cache_follows_env_var(monkeypatch, tmp_path):
    import jax
    from pqp_for_mpc_tpu.utils import cache

    target = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() == target
    assert os.path.isdir(target)
    # the variable is JAX's own setting: nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_repo_dir(monkeypatch):
    import jax
    from pqp_for_mpc_tpu.utils import cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_persistent_cache()
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("name", ["SolverConfig()", "MPC_CONFIG",
                                  "stagewise_mpc_config(512)"])
def test_parity_configs_use_highest_precision(name):
    """'default' lets the GPU run f32 products in TF32; only the
    inert-tolerance throughput harness may use it."""
    from pqp_for_mpc_tpu import config

    cfg = eval(name, vars(config))
    assert cfg.precision == "highest"
    assert config.BENCH_CONFIG.precision == "default"
