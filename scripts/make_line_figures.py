"""Line-case figure family for slam-dense-radio — the analogs of the
reference's committed line-odometry / line-filter-max / line-filter-mean
/ line-smoother PNGs (examples/slam-dense-radio/main.m:55-180): nMC
Monte Carlo trajectory overlays on the true field (odometry) and on the
run-1 estimated map with uncertainty alpha (imagescalpha.m semantics).

Run: timeout 3000 python scripts/make_line_figures.py [nMC] [n_sweeps]
(defaults 100 / 50, the reference config main.m:24-27).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax
import jax.numpy as jnp
import numpy as np

from rbslam_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()
from rbslam_tpu.engines import RBPFConfig, RBPSConfig, run_rbpf, run_rbps
from rbslam_tpu.metrics import aligned_position_rmse
from rbslam_tpu.workloads.dense_radio import DenseRadioConfig, build_problem

N_MC = int(sys.argv[1]) if len(sys.argv) > 1 else 100
N_K = int(sys.argv[2]) if len(sys.argv) > 2 else 50
OUT = os.path.join(ROOT, "results/figures")

cfg = DenseRadioConfig(traj_type="line_3D", n_mc=N_MC, n_sweeps=N_K,
                       with_grid=True)
key = jax.random.PRNGKey(cfg.seed)
field_weights = None
runs = []
t0 = time.time()
first = None
for i_mc in range(N_MC):
    key, k_data, k_f, k_s = jax.random.split(key, 4)
    data, model, basis, k_sd, Q, R = build_problem(
        cfg, k_data, field_weights
    )
    field_weights = data.field_weights
    res = run_rbpf(
        k_f, model, data.dx, data.y, data.init_state,
        jnp.zeros(basis.m), jnp.diag(k_sd), Q, R, 1.0,
        RBPFConfig(n_particles=cfg.n_particles, resampling=cfg.resampling),
    )
    res_s = run_rbps(
        k_s, model, data.dx, data.y, data.init_state,
        jnp.zeros(basis.m), jnp.diag(k_sd), Q, R, 1.0,
        RBPSConfig(n_particles=cfg.n_particles, n_sweeps=N_K,
                   resampling=cfg.resampling),
    )
    jax.block_until_ready(res_s.XNK)
    runs.append({
        "odometry": np.asarray(data.odometry_path[:, :2]),
        "traj_max": np.asarray(res.traj_max[:, :2]),
        "traj_mean": np.asarray(res.traj_mean[:, :2]),
        "traj_smoother": np.asarray(res_s.XNK[-1, :, :2]),
        "rmse_f": float(aligned_position_rmse(
            jnp.asarray(data.pos), res.traj_mean[:, :2])),
        "rmse_s": float(aligned_position_rmse(
            jnp.asarray(data.pos), res_s.XNK[-1, :, :2])),
    })
    if first is None:
        first = (data, basis, res, res_s)
    if (i_mc + 1) % 10 == 0:
        print(f"  MC {i_mc + 1}/{N_MC} ({time.time() - t0:.0f}s)",
              flush=True)

data, basis, res, res_s = first
from rbslam_tpu.basis.laplace import domain_center

center = domain_center(data.LL)
x1t, x2t = data.grid["x1t"], data.grid["x2t"]
X1, X2 = np.meshgrid(x1t, x2t)
pts = np.stack([X1.ravel(), X2.ravel()], -1) - center[None, :2]
Phi = basis.phi(jnp.asarray(pts, jnp.float32))
true_f = np.asarray(data.grid["f"]) if "f" in data.grid else None

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

COLOR = (0 / 255, 93 / 255, 141 / 255)   # the reference's line color
lims = (-0.7, 0.7, -2.0, 2.0)            # main.m:55 xlim/ylim


def panel(fname, img, alpha, trajs, title):
    fig, ax = plt.subplots(figsize=(4.2, 6))
    ax.imshow(
        img.reshape(X1.shape), origin="lower",
        extent=[x1t[0], x1t[-1], x2t[0], x2t[-1]],
        aspect="equal", alpha=alpha, cmap="viridis",
    )
    for tr in trajs:
        ax.plot(tr[:, 0], tr[:, 1], "-", color=COLOR, lw=0.8)
    ax.set_xlim(lims[:2]); ax.set_ylim(lims[2:])
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_title(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(os.path.join(OUT, fname), dpi=130)
    plt.close(fig)
    print("wrote", fname, flush=True)


def alpha_from_var(var):
    u = np.sqrt(np.maximum(var, 0.0)).reshape(X1.shape)
    rng = u.max() - u.min()
    return 1.0 - (u - u.min()) / (rng if rng > 0 else 1.0)


os.makedirs(OUT, exist_ok=True)
# 1) odometry dead-reckoning over the TRUE field (line-odometry.png)
if true_f is not None:
    img_true = np.asarray(true_f)
else:
    img_true = np.zeros(X1.size)
panel("line-odometry.png", img_true, None,
      [r["odometry"] for r in runs],
      f"odometry ({N_MC} MC runs), true field")

# 2) filter max-weight trajectories over run-1 max-weight map
Eft = np.asarray(Phi @ res.xl_max)
var_max = np.asarray(jnp.einsum("ni,ij,nj->n", Phi, res.P_max, Phi))
panel("line-filter-max.png", Eft, alpha_from_var(var_max),
      [r["traj_max"] for r in runs], "filter max-weight")

# 3) filter weighted-mean trajectories over run-1 mean map
Eft_m = np.asarray(Phi @ res.xl_mean)
var_m = np.asarray(jnp.einsum("ni,ij,nj->n", Phi, res.P_mean, Phi))
panel("line-filter-mean.png", Eft_m, alpha_from_var(var_m),
      [r["traj_mean"] for r in runs], "filter weighted mean")

# 4) smoother final-sweep sampled trajectories over run-1 smoother map
Eft_s = np.asarray(Phi @ res_s.XLK[-1])
var_s = np.asarray(jnp.einsum("ni,ij,nj->n", Phi, res_s.PK[-1], Phi))
panel("line-smoother.png", Eft_s, alpha_from_var(var_s),
      [r["traj_smoother"] for r in runs],
      f"smoother (sweep {N_K})")

rf = np.asarray([r["rmse_f"] for r in runs])
rs = np.asarray([r["rmse_s"] for r in runs])
summary = {
    "n_mc": N_MC, "n_sweeps": N_K,
    "rmse_filter_mean": float(rf.mean()),
    "rmse_filter_median": float(np.median(rf)),
    "rmse_smoother_mean": float(rs.mean()),
    "rmse_smoother_median": float(np.median(rs)),
    "wall_s": time.time() - t0,
}
with open(os.path.join(ROOT, "results/line_figures_summary.json"), "w") as f:
    json.dump(summary, f, indent=1)
print(json.dumps(summary), flush=True)
