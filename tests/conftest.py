"""Test configuration: run JAX on a virtual 8-device CPU mesh with f64.

Sharding/multi-chip tests use the virtual devices; physics parity tests need
f64 which is native on CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Force CPU through the config knob too, so the test suite runs on the
# virtual 8-device host mesh whatever accelerator is installed.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REFERENCE = pathlib.Path("/root/reference")

import pytest


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE.exists():
        pytest.skip("reference tree not mounted")
    return REFERENCE
