"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh BEFORE any jax import, so the
device path and the multi-device sharding tests (mesh/shard_map over the
chunk axis) run without an accelerator.  With RIBBIT_TESTS_ON_GPU=1 the
process keeps JAX's own platform instead, and the tests marked `gpu` run
on the card:

    RIBBIT_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import os
import pathlib

import pytest

if os.environ.get("RIBBIT_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(scope="session")
def cpu_jax():
    import jax
    return jax


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    from ribbit_tpu.backend import gpu_present
    if not gpu_present():
        import jax
        pytest.skip(f"needs an NVIDIA GPU; JAX platform is "
                    f"{jax.default_backend()}")


GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLDEN
