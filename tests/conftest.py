import os
import sys

# single-device tests: dryrun.py sets its own XLA_FLAGS in a subprocess;
# everything here sees 1 CPU device.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# the privacy plane (HE shares mod ~2^40, uint64 NTT lanes) needs x64;
# model code is dtype-explicit so enabling it globally is safe.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where none is found)")
