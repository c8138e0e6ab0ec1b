"""Benchmark: RBPF particle-step throughput on the flagship dense-mag model.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "particle-steps/s", "vs_baseline": N}

The reference publishes no timing numbers (BASELINE.md: "published": {});
`vs_baseline` is therefore measured against a faithful single-threaded
NumPy reimplementation of the reference's per-particle loops
(src/particleFilter.m:104-204: sequential resample/propagate/weight/KF
update with BLAS inner algebra) run on this host — the closest available
stand-in for the MATLAB R2022b CPU baseline.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _build_problem(m_basis, n_particles, n_steps, seed=1):
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.basis import ScalarPotentialBasis, hypercube_basis
    from rbslam_tpu.basis.laplace import domain_center
    from rbslam_tpu.basis.spectral import linear_plus_se_spectral
    from rbslam_tpu.data import simulate_dense_dataset
    from rbslam_tpu.models import make_mag3d_model
    from rbslam_tpu.models.mag3d import dynamics_with_increment
    from rbslam_tpu.math.quaternions import quat_to_rmat
    from rbslam_tpu.workloads.dense_mag import default_Q

    theta = (650.0, 1.2, 200.0, 10.0)
    Q = default_Q()
    n_laps = max(1, n_steps // 64)
    data = simulate_dense_dataset(
        jax.random.PRNGKey(seed), "bean_6D", theta, Q, 0.01,
        dynamics_with_increment, m_sim=512,
        traj_kwargs={"n_laps": n_laps, "n_per_lap": n_steps // n_laps},
        with_grid=False,
    )
    potential = ScalarPotentialBasis(hypercube_basis(m_basis, data.LL))
    center = jnp.asarray(domain_center(data.LL), jnp.float32)
    model = make_mag3d_model(potential, center=center)
    k = linear_plus_se_spectral(
        jnp.asarray(np.sqrt(potential.basis.eigenvalues), jnp.float32),
        theta[0], theta[1], theta[2], 3,
    )
    R = jnp.asarray(theta[3] * np.eye(3), jnp.float32)
    return data, model, potential, k, Q, R


def bench_rbpf(m_basis, n_particles, n_steps, repeats=3,
               cov_dtype="float32",
               symmetrize=False, ess_threshold=1.0, kf_kernel="xla",
               lowrank_period=8, store_trajectories=True):
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.engines import RBPFConfig, run_rbpf

    data, model, potential, k, Q, R = _build_problem(
        m_basis, n_particles, n_steps
    )
    cfg = RBPFConfig(n_particles=n_particles, resampling="systematic",
                     cov_dtype=cov_dtype,
                     symmetrize_cov=symmetrize, ess_threshold=ess_threshold,
                     kf_kernel=kf_kernel, lowrank_period=lowrank_period,
                     store_trajectories=store_trajectories)
    args = (
        model, data.dx, data.y, data.init_state,
        jnp.zeros(potential.n_lin), jnp.diag(k), Q, R, 0.01, cfg,
    )
    key = jax.random.PRNGKey(0)
    # compile + warm up
    res = run_rbpf(key, *args)
    jax.block_until_ready(res.logw)
    best = np.inf
    for i in range(repeats):
        t0 = time.perf_counter()
        res = run_rbpf(jax.random.fold_in(key, i), *args)
        jax.block_until_ready(res.logw)
        best = min(best, time.perf_counter() - t0)
    T = int(data.y.shape[0])
    return n_particles * T / best, best, T


def bench_rbps_info(m_basis=512, n_particles=100, n_steps=192, n_sweeps=3,
                    repeats=2):
    """Information-form smoother throughput at REFERENCE scale (N_P=100,
    nl=515, T=192, woodbury ancestor form) — the paper's contribution
    (src/particleSmootherInformationForm.m), tracked round-over-round so
    smoother regressions are visible to the driver (VERDICT r4 #3).
    particle-steps = N_P * T * N_K."""
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.engines import RBPSConfig, run_rbps_information_form

    data, model, potential, k, Q, R = _build_problem(
        m_basis, n_particles, n_steps
    )
    cfg = RBPSConfig(n_particles=n_particles, n_sweeps=n_sweeps,
                     resampling="systematic", ancestor_form="woodbury")
    args = (
        model, data.dx, data.y, data.init_state,
        jnp.zeros(potential.n_lin), jnp.diag(k), Q, R, 0.01, cfg,
    )
    key = jax.random.PRNGKey(0)
    res = run_rbps_information_form(key, *args)
    jax.block_until_ready(res.XNK)
    best = np.inf
    for i in range(repeats):
        t0 = time.perf_counter()
        res = run_rbps_information_form(jax.random.fold_in(key, i), *args)
        jax.block_until_ready(res.XNK)
        best = min(best, time.perf_counter() - t0)
    T = int(data.y.shape[0])
    return n_particles * T * n_sweeps / best, best, T


def bench_pf(n_particles, n_steps, repeats=3):
    """Terrain-matching PF throughput on a gridded magnetic map — the
    no-covariance engine that scales to millions of particles per chip
    (the BASELINE.json 1M-particle north-star path)."""
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.data.fields import draw_scalar_potential_field
    from rbslam_tpu.engines import PFConfig, run_pf_localization
    from rbslam_tpu.models import make_gridded_terrain_model
    from rbslam_tpu.workloads.mag_localization import (
        _heading_quats, _test_loop, default_Q,
    )
    from rbslam_tpu.math.quaternions import qinv, qmul, rmat_to_quat

    theta = (10.0, 1.0, 25.0, 4.0)
    extent = 4.0
    n_grid = 192
    xs = np.linspace(-extent, extent, n_grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    grid_pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    path = _test_loop(extent * 0.9, n_steps)
    LLs = np.stack([[-extent - 1, -extent - 1, -1.0],
                    [extent + 1, extent + 1, 1.0]])
    d = draw_scalar_potential_field(
        jax.random.PRNGKey(0),
        jnp.asarray(np.concatenate([grid_pts, path]), jnp.float32),
        512, LLs, theta,
    )
    mean_grid = d.df[: X.size].reshape(n_grid, n_grid, 3)
    var_grid = jnp.full((n_grid, n_grid, 3), 0.3)
    model = make_gridded_terrain_model(
        mean_grid, var_grid,
        jnp.asarray([xs[0], xs[0]], jnp.float32),
        jnp.asarray([xs[1] - xs[0], xs[1] - xs[0]], jnp.float32),
        theta[3],
    )
    y_path = np.asarray(d.y[X.size:])
    quat, Rm = _heading_quats(path)
    quat = np.asarray(rmat_to_quat(jnp.asarray(Rm.transpose(0, 2, 1))))
    y_body = np.einsum("tij,tj->ti", Rm, y_path)
    dpos = np.diff(path, axis=0)
    dquat = np.asarray(
        qmul(qinv(jnp.asarray(quat[:-1])), jnp.asarray(quat[1:]))
    )
    u = jnp.asarray(np.concatenate([dpos, dquat], -1), jnp.float32)
    key = jax.random.PRNGKey(1)
    init = jnp.concatenate(
        [
            jax.random.uniform(key, (n_particles, 2), minval=-extent,
                               maxval=extent),
            jnp.zeros((n_particles, 1)),
            jnp.tile(jnp.asarray(quat[0], jnp.float32), (n_particles, 1)),
        ],
        axis=-1,
    )
    cfg = PFConfig(n_particles=n_particles, resampling="systematic",
                   ess_threshold=0.5)
    args = (model.dynamics, model.log_weight, u,
            jnp.asarray(y_body, jnp.float32), init, default_Q(), 0.1, cfg)
    res = run_pf_localization(jax.random.PRNGKey(2), *args)
    jax.block_until_ready(res.logw)
    best = np.inf
    for i in range(repeats):
        t0 = time.perf_counter()
        res = run_pf_localization(jax.random.fold_in(key, i), *args)
        jax.block_until_ready(res.logw)
        best = min(best, time.perf_counter() - t0)
    return n_particles * n_steps / best, best


def _numpy_grad_basis(pos, NN, L):
    """Real reduced-rank basis-gradient evaluation, vectorized over the
    ensemble exactly as the reference's dense measModel is
    (src/particleFilter.m:124; tools/domain_cartesian_dx.m:146-170):
    d/dx_k prod_j L_j^-1/2 sin(pi n_j (x_j + L_j) / (2 L_j)).

    pos: [N, 3]; NN: [m, 3]; L: [3]. Returns [N, 3, m].
    """
    w = np.pi * NN / (2.0 * L)                   # [m, 3]
    arg = pos[:, None, :] * w[None] + w[None] * L  # [N, m, 3]
    sin = np.sin(arg)
    cos = np.cos(arg)
    norm = float(np.prod(1.0 / np.sqrt(L)))
    out = np.empty((pos.shape[0], 3, NN.shape[0]))
    for k in range(3):
        others = [j for j in range(3) if j != k]
        out[:, k, :] = (
            norm * w[None, :, k] * cos[:, :, k]
            * sin[:, :, others[0]] * sin[:, :, others[1]]
        )
    return out


def numpy_baseline_per_step(m_basis, n_particles, NN, L, n_steps=8):
    """Single-threaded per-particle-loop RBPF step cost — the reference's
    structure faithfully: per-particle inverse-CDF resampling
    (tools/sample.m:30-33), one vectorized basis/Jacobian evaluation per
    step (src/particleFilter.m:124), then a for-loop of per-particle
    weight + Kalman updates with BLAS inner algebra (:126-204)."""
    rng = np.random.default_rng(0)
    n_lin = 3 + m_basis
    ny = 3
    P = np.tile(np.eye(n_lin, dtype=np.float64), (n_particles, 1, 1))
    xl = rng.normal(size=(n_particles, n_lin))
    w = np.full(n_particles, 1.0 / n_particles)
    R = 10.0 * np.eye(ny)
    y = rng.normal(size=ny)
    xn = rng.uniform(-0.5, 0.5, size=(n_particles, 7))
    Rnb = np.eye(3) + 0.1 * np.array(
        [[0.0, -1.0, 0.5], [1.0, 0.0, -0.2], [-0.5, 0.2, 0.0]]
    )

    t0 = time.perf_counter()
    for _ in range(n_steps):
        # resample + propagate (per particle, tools/sample.m style)
        ai = np.empty(n_particles, dtype=int)
        for i in range(n_particles):
            ai[i] = np.searchsorted(np.cumsum(w), rng.uniform())
        ai = np.clip(ai, 0, n_particles - 1)
        xn = xn[ai] + 0.01 * rng.normal(size=xn.shape)
        xl = xl[ai]
        P = P[ai]
        # real basis eval + body-frame rotation (run_dense3D_magfield.m:
        # 265-279): C = Rnb' [I3 | dPhi]
        g = _numpy_grad_basis(xn[:, :3], NN, L)   # [N, 3, m]
        eye3 = np.broadcast_to(np.eye(3), (n_particles, 3, 3))
        C_all = np.einsum(
            "ji,njk->nik", Rnb, np.concatenate([eye3, g], axis=2)
        )
        logw = np.empty(n_particles)
        for i in range(n_particles):
            C = C_all[i]
            e = y - C @ xl[i]
            S = C @ P[i] @ C.T + R
            Lc = np.linalg.cholesky(S)
            v = np.linalg.solve(Lc, e)
            logw[i] = -np.log(np.diag(Lc)).sum() - 0.5 * v @ v
            K = P[i] @ np.linalg.solve(S, C).T
            xl[i] = xl[i] + K @ e
            P[i] = P[i] - K @ S @ K.T
        c = logw.max()
        w = np.exp(logw - c)
        w /= w.sum()
    elapsed = time.perf_counter() - t0
    return elapsed / (n_steps * n_particles)  # seconds per particle-step


def numpy_baseline_best(m_basis, n_particles, repeats=3):
    """Best-of-N baseline cost — the per-particle loop is deterministic
    work, so min over repeats removes transient host-load noise from the
    reported vs_baseline ratio."""
    from rbslam_tpu.basis import hypercube_basis

    b = hypercube_basis(m_basis, np.array([2.0, 2.0, 1.0]))
    NN = np.asarray(b.NN, dtype=np.float64)
    L = np.asarray(b.L, dtype=np.float64)
    return min(
        numpy_baseline_per_step(m_basis, n_particles, NN, L)
        for _ in range(repeats)
    )


def main():
    from rbslam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--particles", type=int, default=16384)
    ap.add_argument("--basis", type=int, default=125)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--cov-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--engine", default="rbpf", choices=["rbpf", "pf"],
                    help="pf = gridded terrain PF (1M-particle path)")
    ap.add_argument("--symmetrize", action="store_true",
                    help="re-symmetrize P every step (reference filter "
                         "does not; costs an extra HBM pass)")
    ap.add_argument("--ess", type=float, default=1.0,
                    help="ESS resampling threshold (1.0 = every step, "
                         "the reference semantics; <1 skips the P gather "
                         "on non-resampling steps)")
    ap.add_argument("--kf-kernel", default="lowrank",
                    choices=["xla", "lowrank"],
                    help="KF measurement update: xla einsum chain on the "
                         "full P, or lowrank = factored carry "
                         "P = P_base - Wt'Wt, ny rows written per step "
                         "(kernels/kf_update.py)")
    ap.add_argument("--lowrank-period", type=int, default=8,
                    help="rebase period r for --kf-kernel lowrank")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="capture a jax.profiler trace of the timed "
                         "region to LOGDIR")
    ap.add_argument("--skip-pf", action="store_true",
                    help="skip the terrain-PF regression line (faster "
                         "iteration when tuning the RBPF kernel)")
    ap.add_argument("--skip-extras", action="store_true",
                    help="skip the reference-scale filter + smoother "
                         "regression lines")
    args = ap.parse_args()

    if args.quick:
        n_particles, m_basis, n_steps = 128, 32, 64
    else:
        n_particles, m_basis, n_steps = args.particles, args.basis, args.steps

    if args.engine == "pf":
        n_pf = 1_048_576 if args.particles == 16384 else args.particles
        if args.quick:
            n_pf = 4096
        throughput, elapsed = bench_pf(n_pf, 128 if not args.quick else 32)
        print(
            json.dumps(
                {
                    "metric": (
                        f"terrain_pf_particle_steps_per_s[N_P={n_pf}]"
                    ),
                    "value": round(throughput, 1),
                    "unit": "particle-steps/s",
                    "vs_baseline": None,
                }
            )
        )
        return

    import contextlib

    if args.profile:
        from rbslam_tpu.utils.profiling import trace_to

        ctx = trace_to(args.profile)
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        throughput, _, T = bench_rbpf(
            m_basis, n_particles, n_steps,
            cov_dtype=args.cov_dtype, symmetrize=args.symmetrize,
            ess_threshold=args.ess, kf_kernel=args.kf_kernel,
            lowrank_period=args.lowrank_period,
        )

    # baseline cost measured at small particle count, cost/particle-step
    # is particle-count independent (sequential loop)
    base_pp = numpy_baseline_best(m_basis, min(n_particles, 64))
    baseline_throughput = 1.0 / base_pp

    # regression-track the 1M-particle terrain PF (the no-covariance
    # scaling path) alongside the flagship metric; keep the RBPF line
    # LAST (the final JSON line is the headline)
    if not args.skip_pf:
        n_pf = 4096 if args.quick else 1_048_576
        pf_throughput, _ = bench_pf(n_pf, 32 if args.quick else 128)
        print(
            json.dumps(
                {
                    "metric": (
                        f"terrain_pf_particle_steps_per_s[N_P={n_pf}]"
                    ),
                    "value": round(pf_throughput, 1),
                    "unit": "particle-steps/s",
                    "vs_baseline": None,
                }
            )
        )
    if not (args.skip_extras or args.quick):
        # reference-scale rows (VERDICT r4 #1/#3): the flagship accuracy
        # shape nl=512 (m=509+3) in f32 on the factored carry, and the
        # info-form smoother at N_P=100, nl=515, woodbury — the paper's
        # contribution
        ref_tp, _, Tr = bench_rbpf(
            509, 4096, 192, cov_dtype="float32",
            symmetrize=False, kf_kernel="lowrank",
        )
        print(json.dumps({
            "metric": (
                f"rbpf_dense_mag_particle_steps_per_s"
                f"[N_P=4096,m=509+3,T={Tr},lowrank-kf-r8,f32,ref-scale]"
            ),
            "value": round(ref_tp, 1),
            "unit": "particle-steps/s",
            "vs_baseline": None,
        }))
        # bf16 factored carry at reference scale: rounds P only at
        # rebases, so unlike the per-step paths it is stable at
        # n_lin=512 (RESULTS.md)
        ref16_tp, _, _ = bench_rbpf(
            509, 4096, 192, cov_dtype="bfloat16",
            symmetrize=False, kf_kernel="lowrank",
        )
        print(json.dumps({
            "metric": (
                f"rbpf_dense_mag_particle_steps_per_s"
                f"[N_P=4096,m=509+3,T={Tr},lowrank-kf-r8,bf16-cov,"
                "ref-scale]"
            ),
            "value": round(ref16_tp, 1),
            "unit": "particle-steps/s",
            "vs_baseline": None,
        }))
        ps_tp, _, Ts = bench_rbps_info()
        print(json.dumps({
            "metric": (
                f"rbps_info_particle_steps_per_s"
                f"[N_P=100,m=512+3,T={Ts},woodbury]"
            ),
            "value": round(ps_tp, 1),
            "unit": "particle-steps/s",
            "vs_baseline": None,
        }))
        # large-ensemble row (VERDICT r4 #7): N_P=131072 at nl=128 with
        # the factored carry and the [T, N, dn] history tensors skipped
        # (store_trajectories=False; ancestors still returned for
        # offline reconstruction)
        big_tp, _, Tb = bench_rbpf(
            125, 131072, 192, cov_dtype="bfloat16",
            symmetrize=False, kf_kernel="lowrank",
            store_trajectories=False,
        )
        print(json.dumps({
            "metric": (
                f"rbpf_dense_mag_particle_steps_per_s"
                f"[N_P=131072,m=125+3,T={Tb},lowrank-kf-r8,bf16-cov,"
                "no-traj]"
            ),
            "value": round(big_tp, 1),
            "unit": "particle-steps/s",
            "vs_baseline": None,
        }))
    print(
        json.dumps(
            {
                "metric": (
                    f"rbpf_dense_mag_particle_steps_per_s"
                    f"[N_P={n_particles},m={m_basis}+3,T={T}"
                    + (f",lowrank-kf-r{args.lowrank_period}"
                       if args.kf_kernel == "lowrank" else "")
                    + (",bf16-cov" if args.cov_dtype == "bfloat16" else "")
                    + ("" if args.symmetrize else ",no-sym")
                    + (f",ess={args.ess}" if args.ess < 1.0 else "")
                    + "]"
                ),
                "value": round(throughput, 1),
                "unit": "particle-steps/s",
                "vs_baseline": round(throughput / baseline_throughput, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
