"""Test platform setup.

By default every test runs on an 8-device virtual CPU mesh, so the sharded
layers are exercised without hardware.  ``SVIEW_TEST_GPU=1`` keeps JAX's
default platform instead; on a machine with an NVIDIA card that enables
the ``@pytest.mark.gpu`` tests, which compile the query executables for the
card (see README, "Tests").

Card presence and device counts are decided inside fixtures, at run time,
never while tests are collected.
"""
import os

import pytest

if os.environ.get("SVIEW_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: compiles and runs on an NVIDIA card; skips elsewhere")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA card (run with SVIEW_TEST_GPU=1 on one)")


@pytest.fixture
def eight_devices():
    """The 8-device mesh the sharding tests are written for; skips when the
    platform has fewer devices (e.g. one card under SVIEW_TEST_GPU=1)."""
    import jax

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip(f"needs 8 devices, the platform has {len(devices)}")
    return devices[:8]
