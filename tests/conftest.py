"""Test harness configuration.

All tests run on CPU with 8 virtual devices (the reference has no
distributed test fixture at all; this is the fake-multi-device backend
SURVEY.md §4 prescribes) and with x64 enabled so numerical results are
directly comparable to the f64 Rust reference semantics.

``PICARD_TESTS_ON_DEVICE=1`` is the one opt-in that leaves the platform
alone, so that the tests marked ``gpu`` reach the card (chip_smoke.py's
test phase sets it; the README names the command). Without a GPU those
tests skip from inside the ``gpu`` fixture.
"""

import os

ON_DEVICE = os.environ.get("PICARD_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    # Must be set before jax initializes its backends.
    _flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from picard_ica_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_device_mesh():
    from picard_ica_tpu.parallel import sample_mesh

    devices = jax.devices()
    assert len(devices) == 8, f"expected 8 forced host devices, got {len(devices)}"
    return sample_mesh(devices)


@pytest.fixture()
def gpu():
    """The first GPU, or a skip where there is none (decided here, at
    run time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)
