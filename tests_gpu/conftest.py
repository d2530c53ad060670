"""Tests that need an NVIDIA GPU.  Each test is marked ``gpu`` and takes
the ``gpu`` fixture, which skips the test when JAX finds no GPU; the
backends are never pinned here, so the CPU backend stays available as
the reference.

    python -m pytest tests_gpu -m gpu -n 0 -p no:cacheprovider

(``-n 0``: one process, because every process that uses the card
reserves most of its memory.)  ``chip_smoke.py`` runs the same command
in its own process.
"""

import pytest


@pytest.fixture
def gpu():
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs a GPU: JAX found none")
    from sift_jax.perf.cache import enable_compilation_cache

    enable_compilation_cache()
    return devices[0]
