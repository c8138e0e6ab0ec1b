"""Flagship-scale stability check of the lowrank factored-carry path:
m=509 (nl=512), f32, T=192, N_P=100 — the accuracy config
VERDICT r4 #1 asks for. Compares against the xla+symmetrize path on the
same seeds. Run: timeout 3000 python scripts/check_lowrank_flagship.py [nseeds]
"""
import os
import sys, time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax, jax.numpy as jnp, numpy as np
from rbslam_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
from rbslam_tpu.workloads.dense_mag import DenseMagConfig, build_problem
from rbslam_tpu.engines import RBPFConfig, run_rbpf
from rbslam_tpu.metrics import aligned_position_rmse

nseeds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
M = 509

for kernel, sym, dtype in [("lowrank", False, "float32"),
                           ("xla", True, "float32")]:
    rmses, esss, retr, walls = [], [], [], []
    for s in range(nseeds):
        cfg = DenseMagConfig(seed=1 + s, m_basis=M, run_ekf=False,
                             n_sweeps=0)
        k_data = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[1]
        data, y, model, potential, center, k_sd, Q, R = build_problem(
            cfg, k_data)
        rc = RBPFConfig(n_particles=100, resampling="multinomial",
                        cov_dtype=dtype, symmetrize_cov=sym,
                        kf_kernel=kernel)
        t0 = time.perf_counter()
        res = run_rbpf(jax.random.PRNGKey(100 + s), model, data.dx, y,
                       data.init_state, jnp.zeros(potential.n_lin),
                       jnp.diag(k_sd), Q, R, cfg.dt, rc)
        jax.block_until_ready(res.traj_mean)
        wall = time.perf_counter() - t0
        rmse = float(aligned_position_rmse(jnp.asarray(data.pos),
                                           res.traj_mean[:, :3]))
        rmses.append(rmse)
        esss.append(float(res.ess.min()))
        retr.append(int(res.chol_retries))
        walls.append(wall)
        print(f"  seed {s}: rmse={rmse:.4f} ess_min={esss[-1]:.1f} "
              f"retries={retr[-1]} wall={wall:.1f}s", flush=True)
    a = np.array(rmses)
    print(f"{kernel} sym={sym} {dtype}: rmse median={np.median(a):.4f} "
          f"max={a.max():.4f} n_nan={np.isnan(a).sum()} "
          f"wall(min)={min(walls):.1f}s", flush=True)
