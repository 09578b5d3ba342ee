"""A module fixture for test files that hold the port to a JAX program:
the file's programs compiled afresh and kept in memory alone, none loaded
from or written to a persistent compilation cache.  ``lfit_python_tpu.cli``'s
fit, which an earlier test file may run in the same process, turns one on
for the rest of the process (a directory under the home directory, kept
across sessions).  Import the fixture into the test module's namespace."""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache as cc


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_compiles():
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    cc.reset_cache()
