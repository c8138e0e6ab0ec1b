"""Dense 3D magnetic-field SLAM workload (examples/slam-dense-mag/).

Reference config (run_dense3D_magfield.m, main.m): bean_6D trajectory
(N_T=192), dt=0.01, Q = blkdiag(10^2 diag[.05^2,.05^2,.01^2],
diag([.01 .01 .3] deg)^2), theta=[650;1.2;200;10], m=512(+3 linear)
basis functions, N_P=100, N_K=10, constant magnetic disturbance o added
to the measurements (main.m:37-60), EKF baseline (ekf_dense.m), metrics:
Procrustes position RMSE + quaternion-error orientation RMSE.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..basis import ScalarPotentialBasis, hypercube_basis
from ..basis.laplace import domain_center
from ..basis.spectral import linear_plus_se_spectral
from ..data import simulate_dense_dataset
from ..engines import (
    RBPFConfig,
    RBPSConfig,
    run_ekf_dense,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from ..metrics import aligned_position_rmse, orientation_rmse_deg, rms
from ..models import make_mag3d_model
from ..models.mag3d import dynamics_with_increment
from .common import Timer, report


def default_Q():
    """main.m:22: blkdiag(10^2 diag[.05,.05,.01].^2, diag([.01 .01 .3]deg).^2)."""
    qpos = 10.0**2 * np.array([0.05**2, 0.05**2, 0.01**2])
    qori = (np.array([0.01, 0.01, 0.3]) * np.pi / 180.0) ** 2
    return jnp.asarray(np.diag(np.concatenate([qpos, qori])), jnp.float32)


@dataclass(frozen=True)
class DenseMagConfig:
    theta: tuple = (650.0, 1.2, 200.0, 10.0)
    n_particles: int = 100
    n_sweeps: int = 10
    m_basis: int = 512
    m_sim: int = 2000
    dt: float = 0.01
    mag_disturbance: tuple = (0.0, 0.0, 0.0)   # constant offset o (main.m:40)
    n_laps: int = 3
    n_per_lap: int = 64
    resampling: str = "multinomial"
    smoother: str = "info_form"
    run_ekf: bool = True
    run_filter: bool = True
    seed: int = 1
    cov_dtype: str = "float32"
    symmetrize_cov: bool = True
    ancestor_form: str = "woodbury"
    # filter KF update (RBPFConfig.kf_kernel): the "lowrank" factored
    # carry keeps P_base exactly symmetric by construction (Wt'Wt is an
    # identical fp accumulation for (i,j) and (j,i)), so the XLA path's
    # re-symmetrization pass is structurally unnecessary there
    kf_kernel: str = "xla"


def build_problem(cfg: DenseMagConfig, key):
    Q = default_Q()
    data = simulate_dense_dataset(
        key, "bean_6D", cfg.theta, Q, cfg.dt, dynamics_with_increment,
        m_sim=cfg.m_sim,
        traj_kwargs={"n_laps": cfg.n_laps, "n_per_lap": cfg.n_per_lap},
        with_grid=False,
    )
    y = data.y + jnp.asarray(cfg.mag_disturbance, data.y.dtype)

    potential = ScalarPotentialBasis(hypercube_basis(cfg.m_basis, data.LL))
    center = jnp.asarray(domain_center(data.LL), jnp.float32)
    model = make_mag3d_model(potential, center=center)
    k = linear_plus_se_spectral(
        jnp.asarray(np.sqrt(potential.basis.eigenvalues), jnp.float32),
        cfg.theta[0], cfg.theta[1], cfg.theta[2], 3,
    )
    R = jnp.asarray(cfg.theta[3] * np.eye(3), jnp.float32)
    return data, y, model, potential, center, k, Q, R


def run(cfg: DenseMagConfig, _built=None) -> dict:
    key = jax.random.PRNGKey(cfg.seed)
    key, k_data, k_f, k_s = jax.random.split(key, 4)
    data, y, model, potential, center, k, Q, R = (
        _built if _built is not None else build_problem(cfg, k_data)
    )
    pos_true = jnp.asarray(data.pos)
    quat_true = jnp.asarray(data.quat)
    x0_lin = jnp.zeros(potential.n_lin)
    P0 = jnp.diag(k)
    out = {
        "workload": "slam-dense-mag",
        "mag_disturbance": list(cfg.mag_disturbance),
        "n_steps": int(y.shape[0]),
    }

    if cfg.run_filter:
        with Timer() as t_f:
            res = run_rbpf(
                k_f, model, data.dx, y, data.init_state, x0_lin, P0,
                Q, R, cfg.dt,
                RBPFConfig(
                    n_particles=cfg.n_particles, resampling=cfg.resampling,
                    cov_dtype=cfg.cov_dtype,
                    symmetrize_cov=cfg.symmetrize_cov,
                    kf_kernel=cfg.kf_kernel,
                ),
            )
            jax.block_until_ready(res.traj_mean)
        out["rmse_filter_pos"] = [
            float(aligned_position_rmse(pos_true, res.traj_max[:, :3])),
            float(aligned_position_rmse(pos_true, res.traj_mean[:, :3])),
        ]
        out["rmse_filter_ori_deg"] = [
            float(rms(orientation_rmse_deg(quat_true, res.traj_max[:, 3:7]))),
            float(rms(orientation_rmse_deg(quat_true, res.traj_mean[:, 3:7]))),
        ]
        out["filter_s"] = t_f.elapsed
        out["filter_ess_min"] = float(res.ess.min())
        out["filter_chol_retries"] = int(res.chol_retries)
        out["filter_nonfinite"] = int(
            jnp.sum(~jnp.isfinite(res.logw))
            + jnp.sum(~jnp.isfinite(res.traj_mean))
            + jnp.sum(~jnp.isfinite(res.xl_mean))
        )

    if cfg.n_sweeps > 0:
        smoother = (
            run_rbps_information_form
            if cfg.smoother == "info_form"
            else run_rbps
        )
        with Timer() as t_s:
            res_s = smoother(
                k_s, model, data.dx, y, data.init_state, x0_lin, P0,
                Q, R, cfg.dt,
                RBPSConfig(
                    n_particles=cfg.n_particles,
                    n_sweeps=cfg.n_sweeps,
                    resampling=cfg.resampling,
                    cov_dtype=cfg.cov_dtype,
                    symmetrize_cov=cfg.symmetrize_cov,
                    ancestor_form=cfg.ancestor_form,
                ),
            )
            jax.block_until_ready(res_s.XNK)
        out["rmse_smoother_pos"] = [
            float(aligned_position_rmse(pos_true, res_s.XNK[s, :, :3]))
            for s in range(cfg.n_sweeps)
        ]
        out["rmse_smoother_ori_deg"] = [
            float(
                rms(orientation_rmse_deg(quat_true, res_s.XNK[s, :, 3:7]))
            )
            for s in range(cfg.n_sweeps)
        ]
        out["smoother_s"] = t_s.elapsed
        out["smoother_nonfinite"] = int(
            jnp.sum(~jnp.isfinite(res_s.XNK))
            + jnp.sum(~jnp.isfinite(res_s.XLK))
        )

    if cfg.run_ekf:
        x0_ekf = jnp.concatenate(
            [data.init_state[:3] - center, jnp.zeros(3), x0_lin]
        )
        q0 = data.init_state[3:7]
        P0_ekf = jnp.zeros((6 + potential.n_lin, 6 + potential.n_lin))
        P0_ekf = P0_ekf.at[6:, 6:].set(P0)
        with Timer() as t_e:
            res_e = run_ekf_dense(
                potential, data.dx, y, x0_ekf, q0, P0_ekf, Q, R, cfg.dt
            )
            jax.block_until_ready(res_e.x_traj)
        out["rmse_ekf_pos"] = float(
            aligned_position_rmse(pos_true, res_e.x_traj[:, :3])
        )
        out["ekf_s"] = t_e.elapsed
        out["ekf_nonfinite"] = int(jnp.sum(~jnp.isfinite(res_e.x_traj)))

    return out


def run_comparison(cfg: DenseMagConfig, disturbances=(0.0, 1.0, 5.0, 10.0),
                   n_sim: int = 20) -> dict:
    """EKF vs PF vs PS RMSE distributions under constant disturbances —
    the reference's boxplot experiment (main.m:37-60, boxplot-mag.png:
    all RMSE <= 0.3 m). The nSim EKF runs of each disturbance level are
    one vmapped batch (run_ekf_dense_batched) — the whole EKF column
    costs about one sequential run; PF/PS runs stay sequential (they are
    already particle-batched) and reuse the cached compiled scan."""
    from ..engines import run_ekf_dense_batched

    rows = {}
    raw = {}
    for o in disturbances:
        pf, ps, ess_min = [], [], []
        builds = []
        for i in range(n_sim):
            cfg_i = DenseMagConfig(**{
                **cfg.__dict__,
                "mag_disturbance": (0.0, float(o), 0.0),
                "seed": cfg.seed + i,
                "run_ekf": False,
            })
            k_data = jax.random.split(jax.random.PRNGKey(cfg_i.seed), 4)[1]
            built = build_problem(cfg_i, k_data)
            builds.append(built)
            r = run(cfg_i, _built=built)
            pf.append(r["rmse_filter_pos"][1])       # weighted mean
            ps.append(r["rmse_smoother_pos"][-1])    # final sweep
            ess_min.append(r.get("filter_ess_min", float("nan")))

        # batched EKF over the n_sim runs of this disturbance level
        data0, _, _, potential, center, k, Q, R = builds[0]
        x0_lin = jnp.zeros(potential.n_lin)
        x0_ekf = jnp.concatenate(
            [data0.init_state[:3] - center, jnp.zeros(3), x0_lin]
        )
        q0 = data0.init_state[3:7]
        n_ekf = 6 + potential.n_lin
        P0_ekf = jnp.zeros((n_ekf, n_ekf)).at[6:, 6:].set(jnp.diag(k))
        dx_b = jnp.stack([b[0].dx for b in builds])
        y_b = jnp.stack([b[1] for b in builds])
        res_e = run_ekf_dense_batched(
            potential, dx_b, y_b, x0_ekf, q0, P0_ekf, Q, R, cfg.dt
        )
        jax.block_until_ready(res_e.x_traj)
        ekf = [
            float(aligned_position_rmse(
                jnp.asarray(builds[i][0].pos), res_e.x_traj[i, :, :3]
            ))
            for i in range(n_sim)
        ]

        key_o = str(float(o))
        raw[key_o] = {"ekf": ekf, "pf": pf, "ps": ps}
        rows[key_o] = {
            name: {
                "mean": float(np.mean(v)),
                "median": float(np.median(v)),
                "max": float(np.max(v)),
            }
            for name, v in (("ekf", ekf), ("pf", pf), ("ps", ps))
        }
    return {"workload": "slam-dense-mag-comparison", "n_sim": n_sim,
            "n_particles": cfg.n_particles, "n_sweeps": cfg.n_sweeps,
            "m_basis": cfg.m_basis, "ancestor_form": cfg.ancestor_form,
            "rmse_by_disturbance": rows, "raw": raw}


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--compare", action="store_true",
                    help="disturbance-sweep EKF/PF/PS comparison (main.m:37-60)")
    ap.add_argument("--nsim", type=int, default=20)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--basis", type=int, default=512)
    ap.add_argument("--disturbance", type=float, default=0.0,
                    help="constant y-axis offset o in {0,1,5,10} (main.m:40)")
    ap.add_argument("--smoother", default="info_form",
                    choices=["cpf_as", "info_form"])
    ap.add_argument("--no-ekf", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cov-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="covariance/information storage dtype")
    ap.add_argument("--no-symmetrize", action="store_true",
                    help="skip the per-step covariance re-symmetrization "
                         "pass (the reference filter's own semantics)")
    ap.add_argument("--ancestor-form", default="woodbury",
                    choices=["cholesky", "woodbury"],
                    help="info-form ancestor weights: per-step nl^3 "
                         "factorization vs rank-ny inverse maintenance")
    ap.add_argument("--kf-kernel", default="xla",
                    choices=["xla", "lowrank"],
                    help="filter KF update; 'lowrank' (factored carry) "
                         "needs no per-step symmetrization")
    args = ap.parse_args(argv)
    cfg = DenseMagConfig(
        n_particles=10 if args.quick else args.particles,
        n_sweeps=2 if args.quick else args.sweeps,
        m_basis=64 if args.quick else args.basis,
        m_sim=256 if args.quick else 2000,
        mag_disturbance=(0.0, args.disturbance, 0.0),
        n_laps=1 if args.quick else 3,
        smoother=args.smoother,
        run_ekf=not args.no_ekf,
        seed=args.seed,
        cov_dtype=args.cov_dtype,
        symmetrize_cov=not args.no_symmetrize,
        ancestor_form=args.ancestor_form,
        kf_kernel=args.kf_kernel,
    )
    if args.compare:
        report(run_comparison(
            cfg,
            disturbances=(0.0, 1.0) if args.quick else (0.0, 1.0, 5.0, 10.0),
            n_sim=2 if args.quick else args.nsim,
        ))
    else:
        report(run(cfg))


if __name__ == "__main__":
    main()
