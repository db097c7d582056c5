"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without accelerator hardware
(the JAX-native way to test multi-device code, see SURVEY.md section 4).
On the CPU, Pallas kernels run in the interpreter
(expann_tpu.utils.runtime.pallas_interpret).

Tests that need the GPU carry the ``gpu`` marker and ask the ``gpu``
fixture, which skips them when no GPU is present; the check runs inside
the fixture, never at import time, so every worker collects the same
tests.
"""

import os

import pytest

# No persistent compile cache for CPU test runs.
os.environ["EXPANN_NO_CACHE"] = "1"

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]
