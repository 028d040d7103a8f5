"""Test configuration: force an 8-device CPU platform before jax imports.

This gives every test a virtual 8-device mesh for sharding/collective tests
without TPU hardware (SURVEY.md §4).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the shell may pin a TPU platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # 8 virtual devices on a small host: partitions can take >40s (the
    # default hard-termination) to reach a collective rendezvous
    flags = (
        flags
        + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
        + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
    ).strip()
os.environ["XLA_FLAGS"] = flags

# pytest plugins (jaxtyping) import jax before this conftest runs, which
# bakes the env's JAX_PLATFORMS into jax.config — override it directly.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is dominated by XLA:CPU compiles
# on this 1-core host; warm reruns cut the ~47 min wall time sharply.
jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "fullgeom: full-geometry (256², 14/6ch) parity races vs the genuine "
        "reference — slow; gated behind DMF_FULLGEOM=1, run once per round",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs the port's hand-written kernels on a CUDA card; skips "
        "without one (on the card, where jax is absent: python -m pytest "
        "--noconftest -m cuda tests/test_torch_cuda.py)",
    )


@pytest.fixture
def rng():
    return np.random.RandomState(0)
