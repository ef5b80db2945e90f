"""Where JAX keeps its persistent compilation cache: one decision.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and this
module sets no directory of its own. Otherwise the cache goes to the
fixed in-checkout ``benchmarks/.jax_cache`` (listed in ``.gitignore``):
the path is part of the cache key, so a directory that moved between
runs would never hit. bench.py, benchmarks/northstar_config3.py and
chip_smoke.py all call :func:`enable_compile_cache` before compiling.
"""

import os

import jax

#: the in-checkout default used when ``JAX_COMPILATION_CACHE_DIR`` is unset
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "benchmarks", ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache and return the directory in use."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # cache every executable: the fused kernels compile in well under the
    # one-second default threshold, and a cold call pays for each of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return env_dir or DEFAULT_CACHE_DIR
