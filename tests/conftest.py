"""Test harness configuration.

Tests run on the CPU with a virtual 8-device mesh, so the multi-device
logic is exercised without accelerators.  Both settings must be in the
environment before jax is first imported.  Tests that need the GPU are
marked ``gpu`` and skip here (see the ``gpu`` fixture).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from dvda.testutil import oracle  # noqa: E402


@pytest.fixture(scope="session")
def ref_oracle():
    """The reference dvda2wav binary, built on demand; skips if unbuildable."""
    if not oracle.ensure_built():
        pytest.skip("reference oracle could not be built")
    return oracle


@pytest.fixture
def gpu(request):
    """For tests marked ``gpu``: skips unless JAX's default backend is a
    GPU.  Decided when the test runs, never at collection, so every
    worker collects the same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (default backend: {jax.default_backend()});"
                    " run with `python chip_smoke.py` on the card")
