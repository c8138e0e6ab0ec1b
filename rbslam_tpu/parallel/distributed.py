"""Multi-host bootstrap and host-aware mesh construction.

The reference is a single MATLAB process with no distribution story
(SURVEY §2.4/§5); this module is the communication backend the
framework adds on top: `jax.distributed.initialize` for the multi-host
runtime (one process per host, GSPMD collectives compiled by XLA), plus
a mesh builder that keeps the heavy axis inside a host.

Axis-layout rule: the ``particles`` axis carries the resampling gather
— the only large cross-device exchange in the filter (crossing-particle
covariances) — so it should stay on the fast intra-host links; the
cheap weight collectives (psum log-sum-exp, O(N) floats) can cross the
slower inter-host network. `make_hybrid_mesh` therefore puts hosts on
the OUTER particles dimension: particles are contiguous per host and
most systematic-resampling crossings stay host-local (sorted ancestor
indices travel short distances; see parallel/resampling.py).
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Bootstrap the multi-host runtime (idempotent).

    On managed clusters `jax.distributed.initialize()` can auto-detect
    everything; otherwise pass the coordinator explicitly or set JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID. Returns True when a multi-process
    runtime is active after the call, False for the single-process case
    (no-op — every engine works unchanged on one host).
    """
    if jax.process_count() > 1:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )
    if coordinator_address is None and num_processes is None:
        # not a multi-host launch; stay single-process
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_hybrid_mesh(n_map_shards: int = 1) -> Mesh:
    """(particles, map) mesh over ALL processes' devices, hosts outer.

    Device order puts each host's local devices contiguous along the
    particles axis (hosts = outer blocks), so a particle shard's
    neighbors are on-host and only the outermost resampling crossings
    leave the host. The ``map`` axis (covariance basis blocks —
    per-particle matmul partners, latency-sensitive) is always filled
    with devices from the SAME process.
    """
    devices = jax.devices()
    n = len(devices)
    if n % n_map_shards:
        raise ValueError(f"{n} devices not divisible by map={n_map_shards}")
    n_proc = jax.process_count()
    per_proc = n // n_proc
    if n_map_shards > per_proc or per_proc % n_map_shards:
        raise ValueError(
            f"map={n_map_shards} must divide the {per_proc} per-process "
            "devices (the map axis must stay inside one host)"
        )
    # sort by (process, local order): hosts become outer blocks
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devices).reshape(n // n_map_shards, n_map_shards)
    return Mesh(arr, axis_names=("particles", "map"))
