"""Test configuration: force CPU with 8 virtual devices and float64.

Mirrors the strategy in SURVEY.md §7: statistical kernels are validated in
f64 on a virtual multi-device CPU mesh; the GPU runs f32 through
chip_smoke.py and bench.py.  Must set env vars before the first jax import.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the env var is read only when jax is first imported; the config update
# also holds if a plugin imported jax before this file
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compile cache: repeated suite runs skip recompilation of the
# big MCMC programs
from bssm_tpu.core.config import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
