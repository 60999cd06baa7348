"""The persistent compilation cache helper (utils/cache.py).

A poisoned or unwritable cache dir must not abort a run inside JAX's cache
write path.  setup_cache must degrade to cache-OFF (read-only dir), honor
the empty-string escape hatch, tolerate corrupt entries (demoted to
warnings), use exactly the directory JAX_COMPILATION_CACHE_DIR names, and
be the only code that sets a cache path.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import pytest

from raytracinggpu.utils.cache import CHECKOUT_CACHE, setup_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_env(monkeypatch):
    """Save/restore the cache config around each test (including the
    raise-errors and min-compile-time flags setup_cache / tests mutate —
    leaking raise_errors=False would mask real failures suite-wide)."""
    before = {
        "jax_compilation_cache_dir": jax.config.jax_compilation_cache_dir,
        "jax_raise_persistent_cache_errors":
            jax.config.jax_raise_persistent_cache_errors,
        "jax_persistent_cache_min_compile_time_secs":
            jax.config.jax_persistent_cache_min_compile_time_secs,
    }
    yield monkeypatch
    for k, v in before.items():
        jax.config.update(k, v)


def _jit_runs():
    f = jax.jit(lambda x: x * 2.0 + 1.0)
    assert float(f(jnp.float32(3.0))) == 7.0


def test_unwritable_dir_degrades_to_off(tmp_path, cache_env):
    # A path under a regular FILE can never be created or written — the
    # probe fails with OSError for any uid (chmod-based read-only dirs
    # don't bind as root, which is how CI runs).
    blocker = tmp_path / "blocker"
    blocker.write_text("not a dir")
    ro = blocker / "cache"
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(ro))
    setup_cache()
    assert jax.config.jax_compilation_cache_dir is None
    _jit_runs()


def test_empty_env_is_explicit_disable(cache_env):
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", "")
    setup_cache()
    assert jax.config.jax_compilation_cache_dir is None
    _jit_runs()


def _cacheable(x):
    # ONE function object at ONE source location: retracing after
    # clear_caches yields the identical cache key, so the corrupted entry
    # below is really read back.
    return x * 2.0 + 1.0


def test_corrupted_cache_entries_are_nonfatal(tmp_path, cache_env):
    d = tmp_path / "cache"
    d.mkdir()
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    setup_cache()
    assert jax.config.jax_compilation_cache_dir == str(d)
    # errors demoted to warnings: corrupt reads recompile instead of abort
    assert jax.config.jax_raise_persistent_cache_errors is False
    # Write a REAL entry (min compile time 0 so the tiny jit qualifies) ...
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    assert float(jax.jit(_cacheable)(jnp.float32(3.0))) == 7.0
    entries = [p for p in d.iterdir() if p.is_file()]
    assert entries, "no persistent cache entry was written"
    # ... then truncate every entry so the stored executable is garbage.
    for p in entries:
        data = p.read_bytes()
        p.write_bytes(data[: max(1, len(data) // 2)])
    # Drop the in-memory executable: the next call must go through the
    # persistent cache, hit the corrupt bytes, warn, and recompile.
    jax.clear_caches()
    with pytest.warns(UserWarning):
        assert float(jax.jit(_cacheable)(jnp.float32(3.0))) == 7.0


def test_default_repo_cache_still_engages(cache_env):
    cache_env.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert setup_cache() == CHECKOUT_CACHE
    assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE
    assert CHECKOUT_CACHE == str(REPO / ".jax_cache")


def test_env_dir_is_used_verbatim(tmp_path, cache_env):
    d = tmp_path / "elsewhere" / "cache"
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    assert setup_cache() == str(d)
    assert jax.config.jax_compilation_cache_dir == str(d)
    assert d.is_dir()


def test_no_other_code_sets_a_cache_path():
    """Only utils/cache.py names the cache config or a cache directory."""
    sources = [*REPO.glob("*.py"), *(REPO / "raytracinggpu").rglob("*.py")]
    offenders = [
        str(p.relative_to(REPO)) for p in sources
        if p.name != "cache.py"
        and ("jax_compilation_cache_dir" in p.read_text()
             or ".jax_cache" in p.read_text())
    ]
    assert sources and offenders == []
    assert os.path.basename(CHECKOUT_CACHE) == ".jax_cache"
