"""Persistent XLA compilation cache setup.

The pipeline is one large XLA program, so a cold process spends most of
its start-up compiling.  The persistent cache lets every later process
(tests, tools, benchmarks) load the compiled program instead.  Call
before the first jit trace.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Enable the persistent cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: JAX reads it
    itself and this function sets no other path.  Otherwise the cache is
    the fixed ``<repo>/.jax_cache`` (a fixed path, because the path is
    part of what a later process must find again).

    CPU-backed processes skip the cache unless ``SIFT_JAX_CACHE_CPU=1``:
    XLA:CPU caches native machine code for the host it compiled on, and
    a test suite sharing one repository cache across machines with other
    instruction-set extensions could load code this host cannot run."""
    import jax

    plats = (getattr(jax.config, "jax_platforms", None)
             or os.environ.get("JAX_PLATFORMS") or "")
    if "cpu" in plats.split(",")[:1] and not os.environ.get(
            "SIFT_JAX_CACHE_CPU"):
        return None

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything, including sub-second compiles (the default skips
    # entries under 1s, which covers most of the small programs).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
