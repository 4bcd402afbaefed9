"""Test configuration: an 8-device virtual CPU mesh before JAX imports.

Mirrors the reference's CPU-only CI (SURVEY.md §4) while also letting the
multi-device sharding tests run without accelerators
(``--xla_force_host_platform_device_count=8``). ``JAX_PLATFORMS`` defaults
to ``cpu``; the ``gpu``-marked tests run where JAX has a CUDA device
(``python -m pytest -m gpu tests/`` on the card) and skip elsewhere — the
``gpu`` fixture decides, never the import of a test module.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gc  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU: run python -m pytest -m gpu tests/ "
                    "on the card")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite compiles hundreds of programs in one process; with
    round 3's added large-FEC tests, XLA:CPU's LLVM backend started
    SEGFAULTING on a later big compile (deterministically at the
    early-exit while_loop decode) — an upstream compiler bug triggered by
    accumulated in-process state, reproduced with the native C++ loaders
    disabled and with the persistent compilation cache fully reset.
    Releasing executables at module boundaries keeps the process state
    small; the handful of cross-module recompiles cost far less than the
    risk."""
    yield
    jax.clear_caches()
    gc.collect()
