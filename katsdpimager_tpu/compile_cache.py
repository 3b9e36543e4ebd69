"""Where JAX keeps its persistent compilation cache.

The one place the program decides it: ``JAX_COMPILATION_CACHE_DIR`` when
the environment sets it (JAX reads the variable itself, so nothing is set
here), and otherwise the fixed directory ``<checkout>/.jax_cache``.  A
fixed path matters because the path is part of each entry's key: a cache
that moves never hits.
"""

from __future__ import annotations

import os

#: The checkout's own cache directory (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn on the persistent cache for every compilation; returns its
    directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
