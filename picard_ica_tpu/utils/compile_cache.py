"""The persistent XLA compilation cache every entry point shares.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and
no other is set. Otherwise the cache lives at one fixed path inside the
checkout, ``<repo>/.jax_cache`` (gitignored). The path is part of the
cache's key, so it must not move between runs: no temporary directory,
process id or timestamp.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the
    fixed in-checkout default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    and cache every executable; returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
