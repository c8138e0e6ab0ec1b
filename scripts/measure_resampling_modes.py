"""Scaling-shape measurement of the distributed resampling modes on the
virtual 8-device CPU mesh (VERDICT r3 ask #6): per-call time of
replicated_cdf / prefix / local vs N, plus the analytic collective
payload per call. CPU-mesh times are functional-scaling indicators
(real device collectives are far faster); the payload column is the
architecture claim.

Run: timeout 1800 python scripts/measure_resampling_modes.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from rbslam_tpu.parallel import make_mesh
from rbslam_tpu.parallel.resampling import (
    sharded_resample_indices,
    sharded_resample_local,
)
from rbslam_tpu.ops.resampling import resample_indices

S = 8
mesh = make_mesh(S, 1, devices=jax.devices()[:S])
key = jax.random.PRNGKey(0)


def bench(f, *args, reps=20):
    out = f(*args)
    jax.block_until_ready(out)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


print(f"{'N':>8s} {'single':>10s} {'repl_cdf':>10s} {'prefix':>10s} "
      f"{'local':>10s}   payload/call (index-side)")
for logn in (14, 16, 18, 20):
    n = 2 ** logn
    w = jax.random.uniform(jax.random.PRNGKey(1), (n,))
    w = w / w.sum()

    t_single = bench(
        jax.jit(lambda k, ww: resample_indices(k, ww, n, "systematic")),
        key, w,
    )
    t_repl = bench(
        jax.jit(lambda k, ww: sharded_resample_indices(
            k, ww, mesh, "systematic", "replicated_cdf")),
        key, w,
    )
    t_prefix = bench(
        jax.jit(lambda k, ww: sharded_resample_indices(
            k, ww, mesh, "systematic", "prefix")),
        key, w,
    )
    t_local = bench(
        jax.jit(lambda k, ww: sharded_resample_local(k, ww, mesh)),
        key, w,
    )
    payload = (
        f"repl={4*n//1024}KiB all_gather, "
        f"prefix={4*n//1024}KiB psum_scatter+{4*S}B, local=0B"
    )
    print(f"{n:8d} {t_single*1e3:9.2f}m {t_repl*1e3:9.2f}m "
          f"{t_prefix*1e3:9.2f}m {t_local*1e3:9.2f}m   {payload}")
