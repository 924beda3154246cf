"""Test configuration: run on a simulated 8-device CPU mesh with x64 enabled.

Mirrors the survey's test strategy (SURVEY.md §4): scipy is the oracle; the
virtual CPU mesh is how multi-chip sharding logic is validated without real
multi-chip hardware; x64 keeps the reference's f64 pockets (wiener,
lambert_w) exact. On the GPU the program runs as `python chip_smoke.py`,
then `python bench.py`; neither is part of this suite.
"""

import os

# The tests run on the CPU (JAX_PLATFORMS=cpu). The XLA flag must be set
# before the CPU backend initializes (backend init is lazy, so setting it
# here works even if jax was already imported); the platform is also pinned
# through jax.config in case jax read the environment before this file.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def assert_all_close(actual, expected, atol=1e-4, rtol=1e-4, err_msg=""):
    """Default tolerance gate matching the reference's assert_all_close
    (reference: test/support/nx_signal_case.ex:44-60)."""
    np.testing.assert_allclose(
        np.asarray(actual), np.asarray(expected), atol=atol, rtol=rtol, err_msg=err_msg
    )


# ---------------------------------------------------------------- test tiers
# Fast tier: `pytest -m "not slow"` (1567 tests as of r05; ~18-22 min —
# the doctest subprocess now executes 100% of examples, ~4 min) — run
# before every commit.
# Full suite: 1731 tests, 50 min full-green on the 2-vCPU image (timed
# 2026-08-21, end of round 5).
# Modules listed here are auto-marked slow (8-virtual-device shard_map
# compiles dominate their runtime); individual tests can also opt in with
# @pytest.mark.slow.
SLOW_MODULES = {
    "test_sharded",
    "test_sharded_resample",
    "test_sharded_estimation",
    "test_guides",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
