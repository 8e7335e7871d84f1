"""Test config: run on a virtual 8-device CPU mesh unless told otherwise.

Multi-device sharding tests run on XLA's host-platform virtual devices
(SURVEY.md §4). `JAX_PLATFORMS` picks another backend: the tests marked
`gpu` need one, e.g. `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (excluded from the fast lane: "
        "pytest -m 'not slow', ~3-4 min)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (skips elsewhere); run with "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/",
    )
