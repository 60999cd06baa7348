"""Persistent XLA compilation cache: the one place that configures it.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py`` and
``__graft_entry__.py``) calls ``setup_cache()`` once before compiling.

- ``JAX_COMPILATION_CACHE_DIR`` set and non-empty: the cache lives there,
  and no code sets any other path.
- ``JAX_COMPILATION_CACHE_DIR`` set but empty: the cache stays off.
- Not set: the cache lives at ``<checkout>/.jax_cache`` (git-ignored).  The
  path is part of the cache key, so it is fixed rather than per-user.

A directory that cannot be written leaves the cache off with a warning,
and cache read/write errors are demoted to warnings, so a bad cache never
aborts a run.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str | None:
    """Where the cache goes under the current environment (None = off)."""
    if ENV in os.environ:
        return os.environ[ENV] or None
    return CHECKOUT_CACHE


def setup_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``cache_dir()``.
    Returns the directory in use, or None when the cache is off."""
    path = cache_dir()
    if path is not None:
        try:
            os.makedirs(path, exist_ok=True)
            # Per-process probe name: concurrent callers must not race
            # each other's remove.
            probe = os.path.join(path, f".write_probe.{os.getpid()}")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
        except OSError as e:
            import warnings

            warnings.warn(
                f"persistent compilation cache disabled: {path!r} is not "
                f"writable ({e})", stacklevel=2)
            path = None
    jax.config.update("jax_compilation_cache_dir", path)
    if path is not None:
        jax.config.update("jax_raise_persistent_cache_errors", False)
    return path
