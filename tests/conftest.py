"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on this CPU mesh.  Tests that need the
GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them where JAX finds no GPU; ``bench.py`` and ``chip_smoke.py``
measure on the card outside pytest.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pstl_tpu.utils import device  # noqa: E402

device.configure_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; JAX found none")
    return devs[0]
