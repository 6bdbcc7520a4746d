"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding is exercised without accelerators (SURVEY.md §4).
Pallas kernels run in interpret mode there. Set ``SBR_TEST_PLATFORM`` to
run the suite against another platform explicitly.

Checks that need a GPU carry the ``gpu`` marker and skip elsewhere;
``python chip_smoke.py`` runs the main path and its kernels on the card.
"""

import os

_platform = os.environ.get("SBR_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided per test,
    never at import: every xdist worker must collect the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")
