"""Test harness: CPU backend with a virtual 8-device mesh by default.

Multi-device sharding tests run on virtual CPU devices (the standard JAX
substitute for multi-device testing, SURVEY §4). Tests marked ``gpu``
need the card: run them there with ``JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/`` (one process, so one JAX client holds the card); on the
CPU they skip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from rbslam_tpu.utils.cache import enable_compilation_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: the suite's wall time is dominated by
# XLA compiles of many small distinct programs (8-virtual-device
# shard_map programs especially); cached reruns are much faster.
enable_compilation_cache(min_compile_time_secs=0.1)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture(autouse=True)
def _needs_card(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided per test, never at import, so every xdist worker collects
    the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (a Pallas/Triton kernel compiled "
                    "for the card has no CPU lowering)")
