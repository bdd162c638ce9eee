"""Test configuration: force JAX onto a virtual 8-device CPU mesh so tests
run anywhere (the multi-device sharding analogue of the reference's
single-machine functional tests, SURVEY.md §4).

JAX_PLATFORMS is pinned before JAX is imported, and the config is updated
too in case JAX was imported earlier. Tests that need an NVIDIA GPU carry
the ``gpu`` marker and take the ``gpu`` fixture, which skips them here;
``python3 chip_smoke.py`` runs their bodies on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; "
        "chip_smoke.py runs these bodies on the card)")


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; otherwise skip."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev
