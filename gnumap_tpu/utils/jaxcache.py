"""Persistent XLA compilation cache, kept across processes and runs."""

import os

# the checkout root: two levels above this package's utils/ directory
_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself), else
    .jax_cache/ at the checkout root."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
