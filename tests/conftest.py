import os

# Must run before jax import: tests run on a virtual 8-device CPU mesh so
# sharding paths are exercised without accelerator hardware. Force CPU
# even on a host that has one, unless KCFTOOLS_TEST_GPU=1 asks for the
# card (the `gpu`-marked tests: KCFTOOLS_TEST_GPU=1 pytest -m gpu).
if os.environ.get("KCFTOOLS_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# keep --engine auto on the host path by default so the e2e net stays
# fast; dedicated multichip tests opt back in by clearing this
os.environ.setdefault("KCFTOOLS_NO_DEVICE_PROBE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kcftools_tpu.utils.logger import Logger  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided
    here, at run time, so every test worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev
