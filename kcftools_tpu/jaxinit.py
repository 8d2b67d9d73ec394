"""JAX runtime configuration, applied on first import of any
device-tier module (the host tier never imports JAX - keeping the
stream subcommands and the hybrid engine free of the multi-second JAX
startup cost).

64-bit support: k-mer count sums and score math use float64/int64 on
host; device code is told explicitly which dtypes to use. Enabling x64
keeps host<->device dtype handling consistent.

Persistent compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing here overrides it. Otherwise compiled
programs go to ``<checkout>/.jax_cache`` - a fixed path, because the
path is part of the cache key.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
