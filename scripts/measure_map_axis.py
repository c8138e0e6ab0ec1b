"""Measure the map-axis Schur block reduction at mag-localization scale
(nl ~ 1024, SURVEY §2.4 row 2) on the virtual 8-device CPU mesh:
row-sharded Woodbury ancestor-weight transitions + quadratic vs the
replicated forms. Prints a memory/step-time table (RESULTS.md).

Run: timeout 1800 python scripts/measure_map_axis.py
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

from rbslam_tpu.engines.rbps_info import _woodbury_rank_ny
from rbslam_tpu.parallel import make_mesh
from rbslam_tpu.parallel.map_axis import (
    quad_form_rowsharded,
    woodbury_rank_ny_rowsharded,
)

N_P, NL, NY = 16, 1024, 3   # nl ~ the m=1000 mag-localization scale


def bench(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


key = jax.random.PRNGKey(0)
A = 0.1 * jax.random.normal(key, (N_P, NL, NL))
M = jnp.einsum("pij,pkj->pik", A, A) + 3.0 * jnp.eye(NL)
W0 = jnp.linalg.inv(M)
hld0 = 0.5 * jnp.linalg.slogdet(M)[1]
U = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (N_P, NL, NY))
v = jax.random.normal(jax.random.PRNGKey(2), (N_P, NL))

print(f"N_P={N_P}, nl={NL}, ny={NY}")
mat_mb = N_P * NL * NL * 4 / 2**20
print(f"W ensemble: {mat_mb:.0f} MB f32 replicated")

# replicated baseline (jitted chain of one up + one down transition + quad)
@jax.jit
def repl_step(W, hld):
    W, hld, _ = _woodbury_rank_ny(W, hld, U, 1.0, 1e-9)
    W, hld, _ = _woodbury_rank_ny(W, hld, 0.2 * U, -1.0, 1e-9)
    q = jnp.einsum("pi,pij,pj->p", v, W, v)
    return W, hld, q

t_repl, out_repl = bench(repl_step, W0, hld0)

rows = [("replicated (1 device)", 1, mat_mb, t_repl * 1e3)]
for n_map in (2, 4, 8):
    mesh = make_mesh(8 // n_map, n_map, devices=jax.devices()[:8])
    wood = woodbury_rank_ny_rowsharded(mesh)
    quad = quad_form_rowsharded(mesh)

    @jax.jit
    def sh_step(W, hld):
        W, hld, _ = wood(W, hld, U, 1.0)
        W, hld, _ = wood(W, hld, 0.2 * U, -1.0)
        q = quad(v, W)
        return W, hld, q

    from jax.sharding import NamedSharding, PartitionSpec as P
    W_sh = jax.device_put(
        W0, NamedSharding(mesh, P("particles", "map", None))
    )
    hld_sh = jax.device_put(hld0, NamedSharding(mesh, P("particles")))
    t_sh, out_sh = bench(sh_step, W_sh, hld_sh)
    # equivalence at scale
    np.testing.assert_allclose(
        np.asarray(out_sh[2]), np.asarray(out_repl[2]), rtol=2e-3
    )
    per_dev = mat_mb / (8 // n_map) / n_map
    rows.append((f"row-sharded map={n_map}", n_map, per_dev, t_sh * 1e3))

print()
print(f"{'config':28s} {'W MB/device':>12s} {'2xWoodbury+quad ms':>20s}")
for name, n_map, mb, ms in rows:
    print(f"{name:28s} {mb:12.1f} {ms:20.2f}")
