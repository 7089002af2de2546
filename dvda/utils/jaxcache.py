"""Persistent XLA compilation cache (process-global, enabled once).

The decode pipeline compiles one XLA program per (geometry bucket ×
mode).  The programs are deterministic functions of the geometry, so
JAX's persistent compilation cache turns every repeat compile — across
tracks, processes and service restarts — into a disk read.

One rule decides where the cache lives (``config.env_compile_cache``):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no directory of its own;
* otherwise the fixed ``<checkout>/.jaxcache`` (gitignored);
* ``DVDA_COMPILE_CACHE=0`` turns the default off.
"""

from __future__ import annotations

import os

__all__ = ["ensure_compile_cache"]

_applied: str | None = None


def ensure_compile_cache() -> str | None:
    """Enable the persistent compilation cache (idempotent; call before
    the first traced call — package ``ops/__init__`` does).  Returns the
    active cache dir or None."""
    global _applied
    if _applied is not None:
        return _applied or None

    from ..config import env_compile_cache

    path = env_compile_cache()
    if not path or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _applied = path  # "" = off; JAX's own variable needs nothing
        return path or None
    try:
        os.makedirs(path, exist_ok=True)
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    except Exception as exc:  # unwritable checkout, ...
        from .log import logger

        logger.warning("compile cache disabled (%s): %s", path, exc)
        _applied = ""
        return None
    _applied = path
    return path
