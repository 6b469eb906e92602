"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors SURVEY.md §4.9: distributed code paths are tested without a cluster
by forcing the host platform to expose 8 virtual devices.  The platform is
pinned programmatically (jax.config) and XLA_FLAGS is set before the first
backend access, so the suite runs on the CPU even where an accelerator is
present.

Tests marked `gpu` need a GPU and take the `gpu_device` fixture, which
skips them here; `chip_smoke.py` runs them on the card.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run on the card by chip_smoke.py")


@pytest.fixture
def gpu_device():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return device
