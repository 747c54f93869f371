"""Module fixtures for the port's engine-heavy test files.  Import them
into a test file:

    from port_fixtures import one_torch_thread  # noqa: F401

``one_torch_thread`` runs the file's torch work on one intra-op thread:
the suite spreads its files over parallel worker processes, each
worker's torch threads then oversubscribe the cores, and files of many
small torch ops stall (the training file: 782 s with torch's default
threads beside five other workers, 103 s with one).

``reference_compile_cache`` keeps the reference engine's compiled
forwards for the file in a persistent compilation cache under the
test's temporary directory.  The reference model's eager ``lax.scan``
compiles anew on every forward (about half a second each); with the
cache a forward of a shape compiled before loads instead.  The
executables are the same, so are the results.  The suite's own opt-in
cache (``JAX_TEST_CACHE``, tests/conftest.py) takes precedence."""

import pytest
import torch

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_compile_cache(tmp_path_factory):
    import jax
    from jax._src import compilation_cache
    old = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    if old["jax_compilation_cache_dir"]:
        yield
        return
    compilation_cache.reset_cache()
    jax.config.update("jax_compilation_cache_dir",
                      str(tmp_path_factory.mktemp("jax_compile_cache")))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
