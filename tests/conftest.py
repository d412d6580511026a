"""Test configuration: force an 8-device virtual CPU mesh.

Tests run on CPU with 8 virtual devices so multi-device sharding paths are
exercised without the hardware (SURVEY §4 implication: 1-device vs N-device
equality tests).  The platform is pinned in the config as well as by
``JAX_PLATFORMS``, so a run that forgets the variable still stays on the CPU.
Must run before any JAX backend use.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: golden renders, finite-difference gradients, multi-device "
        "renders and other multi-minute tests; the smoke tier is "
        "`pytest -m 'not slow'` (< 3 min)",
    )
