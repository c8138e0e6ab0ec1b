"""Produce the dense-mag path/field figure analog
(examples/slam-dense-mag/mag-path-field.png): reference-scale RBPF run,
then the estimated field-magnitude map ||C(x) xl|| on the visualization
grid with per-pixel alpha from the posterior uncertainty
(imagescalpha.m semantics), the SLAM trajectory overlaid.

Run (CPU is fine): timeout 2400 python scripts/make_mag_figure.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from rbslam_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from rbslam_tpu.workloads.dense_mag import DenseMagConfig, build_problem
from rbslam_tpu.engines import RBPFConfig, run_rbpf
from rbslam_tpu.viz import plot_dense_map, plot_trajectories

cfg = DenseMagConfig(n_particles=100, n_sweeps=0, m_basis=512, m_sim=2000,
                     seed=1)
key = jax.random.PRNGKey(cfg.seed)
key, k_data, k_f, _ = jax.random.split(key, 4)
data, y, model, potential, center, k, Q, R = build_problem(cfg, k_data)

res = run_rbpf(
    k_f, model, data.dx, y, data.init_state, jnp.zeros(potential.n_lin),
    jnp.diag(k), Q, R, cfg.dt,
    RBPFConfig(n_particles=cfg.n_particles, resampling=cfg.resampling,
               symmetrize_cov=True),
)
jax.block_until_ready(res.xl_mean)

# field magnitude + uncertainty on the visualization grid at the path's
# median height
pos = np.asarray(data.pos)
z0 = float(np.median(pos[:, 2]))
n_g = 80
x1t = np.linspace(data.LL[0][0], data.LL[1][0], n_g)
x2t = np.linspace(data.LL[0][1], data.LL[1][1], n_g)
X1, X2 = np.meshgrid(x1t, x2t)
pts = jnp.asarray(
    np.stack([X1.ravel(), X2.ravel(), np.full(X1.size, z0)], -1),
    jnp.float32,
) - center[None, :]

C = jax.vmap(potential.grad_blocks)(pts)            # [G, 3, nl]
field = jnp.einsum("gij,j->gi", C, res.xl_mean)
mag = jnp.linalg.norm(field, axis=-1)
# posterior std of the field magnitude proxy: sqrt(tr(C P C'))
var = jnp.einsum("gij,jk,gik->g", C, res.P_mean, C)
std = jnp.sqrt(jnp.maximum(var, 0.0))

plot_dense_map(
    "results/figures/mag-path-field.png", x1t, x2t, np.asarray(mag),
    traj=np.asarray(res.traj_mean[:, :2]),
    uncertainty=np.asarray(std),
    title="dense-mag: estimated |B| (alpha = posterior certainty)",
)
plot_trajectories(
    "results/figures/mag-trajectories.png",
    truth=pos[:, :2],
    estimates=[np.asarray(res.traj_mean[:, :2]),
               np.asarray(res.traj_max[:, :2])],
    labels=["filter weighted mean", "filter max-weight"],
)
print("wrote results/figures/mag-path-field.png and mag-trajectories.png")
from rbslam_tpu.metrics import aligned_position_rmse
print("filter rmse:",
      float(aligned_position_rmse(jnp.asarray(pos), res.traj_mean[:, :3])))
