"""Shared test config.

TPU-less CI trick (SURVEY.md §4 takeaway 4): force the JAX CPU platform with
8 virtual host devices so mesh/collective/sharding tests run without chips —
the TPU-world equivalent of the reference's gloo-backend collective tests
(python/ray/util/collective/tests/single_node_cpu_tests)."""

import os
import sys

# Must be set before any jax import anywhere in the test process.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: excluded from the tier-1 run (-m 'not slow')"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one"
    )
    # Reap debris from SIGKILLed prior runs (orphaned node_main/worker
    # daemons + /dev/shm/rtshm_* segments): leaked daemons hold CPU and
    # cascade-fail serve tests late in the suite. Safe concurrently —
    # only processes whose spawning driver is GONE are killed.
    from ray_tpu.core import cluster_utils

    swept = cluster_utils.sweep_stale_runtime()
    if swept["killed"] or swept["removed"]:
        print(
            f"[conftest] swept stale runtime: {swept['killed']} orphaned "
            f"daemon(s), {swept['removed']} shm/spill path(s)"
        )


@pytest.fixture(scope="session")
def cpu_mesh_devices():
    import jax

    jax.config.update("jax_platforms", "cpu")
    devices = jax.devices("cpu")
    assert len(devices) == 8, f"expected 8 virtual cpu devices, got {len(devices)}"
    return devices


@pytest.fixture
def rt_init():
    """Fresh single-node ray_tpu runtime per test."""
    import ray_tpu

    ray_tpu.init(num_cpus=4)
    yield ray_tpu
    ray_tpu.shutdown()
