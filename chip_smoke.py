"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards

Phases, each printing one JSON line with its seconds:

1. device: fail unless JAX's default device is a GPU; print the card's
   name and power limit (nvidia-smi) and the jax/jaxlib versions;
2. kernel parity: each Pallas/Triton kernel as compiled for the card
   against its plain jnp reference at highest matmul precision, at real
   widths;
3. dense-mag at its CLI defaults (reference scale: N_P=100, m=512+3,
   T=192, 10 info-form smoother sweeps, EKF baseline) with the
   reference's 0.3 m position-RMSE bound;
4. the factored-carry filter at N_P=4096, m=509+3 in f32 and bf16 and
   the XLA filter in f32 (0.3 m bound each), then the bench's flagship
   shape (N_P=16384, m=125+3, bf16); particle-steps/s of each;
5. dense-radio, sparse-visual and mag-localization at their CLI defaults
   with the bounds their CPU tests assert;
6. (--four-cards only) the sharded filter and information-form smoother
   over 4x1 and 2x2 meshes against the single-card run: in float32 up to
   the first differing ancestor, in float64 over the whole run (see
   :func:`phase_four_cards`).

One process drives the card(s). Any failed gate raises, so the script
exits non-zero; the last line is the JSON device record only on success.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# reference boxplot bound on position RMSE (RESULTS.md, boxplot-mag.png)
RMSE_BOUND_M = 0.3
# kernel parity tolerance, relative to the output's max: kernel and
# reference read the same stored values and accumulate in f32, so f32
# storage differs only by summation order over nl <= 515 terms; with
# bf16 storage the rebase's reference rounds twice (the product, then
# the difference) where the kernel rounds once, about one bf16 ulp
PARITY_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARITY_WIDTHS = [            # (N, nl, storage dtype); ny = 3
    (16384, 128, "bfloat16"),
    (16384, 128, "float32"),
    (4096, 512, "float32"),
    (4096, 515, "float32"),   # ragged: masked tiles
]


def _emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": time.perf_counter() - t0, **fields},
                     default=lambda v: np.asarray(v).tolist()),
          flush=True)


def _gate(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"gate failed: {what}")


def phase_device():
    import jax
    import jaxlib

    t0 = time.perf_counter()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    _emit("device", t0, card=card.splitlines(), jax=jax.__version__,
          jaxlib=jaxlib.__version__, device_kind=devs[0].device_kind,
          count=len(devs))
    return devs, card.splitlines()[0]


def phase_kernel_parity():
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.kernels import kf_update

    ny, rw = 3, 24
    pairs = {  # kernel as dispatched on CUDA vs its plain reference
        "gather_cp": (jax.jit(kf_update.gather_cp),
                      jax.jit(kf_update.gather_cp_reference)),
        "rebase": (jax.jit(kf_update.kf_rebase),
                   jax.jit(kf_update.rebase_reference)),
    }
    for n, nl, dtype in PARITY_WIDTHS:
        ks = jax.random.split(jax.random.PRNGKey(nl), 4)
        dt = jnp.dtype(dtype)
        P_base = jax.random.normal(ks[0], (n, nl, nl), dt)
        C = (0.3 * jax.random.normal(ks[1], (n, ny, nl))).astype(dt)
        Wt = (0.1 * jax.random.normal(ks[2], (n, rw, nl))).astype(dt)
        bidx = jax.random.randint(ks[3], (n,), 0, n)
        for name, (kernel, reference) in pairs.items():
            t0 = time.perf_counter()
            args = (bidx, C, Wt, P_base) if name == "gather_cp" \
                else (bidx, Wt, P_base)
            out = kernel(*args).astype(jnp.float32)
            with jax.default_matmul_precision("highest"):
                ref = reference(*args).astype(jnp.float32)
            err = float(jnp.max(jnp.abs(out - ref)))
            rel = err / float(jnp.max(jnp.abs(ref)))
            _emit("kernel_parity", t0, kernel=name, N=n, nl=nl, ny=ny,
                  rw=rw, dtype=dtype, max_abs_err=err, max_rel_err=rel,
                  tol=PARITY_TOL[dtype])
            _gate(rel <= PARITY_TOL[dtype]
                  and bool(jnp.all(jnp.isfinite(out))),
                  f"{name} parity N={n} nl={nl} {dtype}: rel {rel}")
            del out, ref
        del P_base, C, Wt


def phase_dense_mag_reference():
    from rbslam_tpu.workloads import dense_mag

    t0 = time.perf_counter()
    out = dense_mag.run(dense_mag.DenseMagConfig())
    _emit("dense_mag_reference", t0, **out)
    _gate(out["rmse_filter_pos"][1] <= RMSE_BOUND_M, "filter RMSE <= 0.3 m")
    _gate(out["rmse_smoother_pos"][-1] <= RMSE_BOUND_M,
          "final-sweep smoother RMSE <= 0.3 m")
    _gate(bool(np.isfinite(out["rmse_ekf_pos"])), "EKF RMSE finite")
    _gate(out["filter_nonfinite"] == 0 and out["smoother_nonfinite"] == 0
          and out["ekf_nonfinite"] == 0, "no NaN in any output")


def _timed_filter(card, gate_rmse, **cfg_fields):
    """Filter-only dense-mag run: compile + warm-up, then one timed run
    of the same compiled program (its particle-steps/s)."""
    import jax

    from rbslam_tpu.workloads import dense_mag

    t0 = time.perf_counter()
    cfg = dense_mag.DenseMagConfig(n_sweeps=0, run_ekf=False, **cfg_fields)
    k_data = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[1]
    built = dense_mag.build_problem(cfg, k_data)
    first = dense_mag.run(cfg, _built=built)
    out = dense_mag.run(cfg, _built=built)
    rate = cfg.n_particles * out["n_steps"] / out["filter_s"]
    _emit("filter", t0, card=card, N_P=cfg.n_particles,
          n_lin=3 + cfg.m_basis, T=out["n_steps"], kf_kernel=cfg.kf_kernel,
          cov_dtype=cfg.cov_dtype, first_run_s=first["filter_s"],
          filter_s=out["filter_s"], particle_steps_per_s=rate,
          rmse_filter_pos=out["rmse_filter_pos"],
          chol_retries=out["filter_chol_retries"],
          nonfinite=out["filter_nonfinite"])
    _gate(out["filter_nonfinite"] == 0, "no NaN in the filter")
    if gate_rmse:
        _gate(out["rmse_filter_pos"][1] <= RMSE_BOUND_M,
              f"{cfg.kf_kernel}/{cfg.cov_dtype} filter RMSE <= 0.3 m")


def phase_factored_carry(card):
    for kf_kernel, cov_dtype in (("lowrank", "float32"),
                                 ("lowrank", "bfloat16"),
                                 ("xla", "float32")):
        _timed_filter(card, True, n_particles=4096, m_basis=509,
                      kf_kernel=kf_kernel, cov_dtype=cov_dtype)
    # the bench's flagship shape (m=125+3 is its own map, no 0.3 m bound)
    _timed_filter(card, False, n_particles=16384, m_basis=125,
                  kf_kernel="lowrank", cov_dtype="bfloat16")


def phase_other_workloads():
    from rbslam_tpu.workloads import dense_radio, mag_localization
    from rbslam_tpu.workloads import sparse_visual

    t0 = time.perf_counter()
    out = dense_radio.run(dense_radio.DenseRadioConfig())
    _emit("dense_radio", t0, **out)
    rf = np.asarray(out["rmse_filter_all"])
    _gate(bool(np.all(np.isfinite(rf)) and np.all(rf < 1.0)),
          "dense-radio filter RMSE < 1.0 m")
    _gate(bool(np.isfinite(out["rmse_smoother_final"])),
          "dense-radio smoother RMSE finite")

    t0 = time.perf_counter()
    out = sparse_visual.run(sparse_visual.SparseVisualConfig())
    _emit("sparse_visual", t0, **out)
    _gate(bool(np.isfinite(out["pf"]["rmse_path"])), "sparse PF path finite")
    _gate(out["pf"]["rmse_map"] < 2.0, "sparse PF map RMSE < 2.0")
    _gate(bool(np.isfinite(out["ps"]["rmse_map"])), "sparse PS map finite")

    t0 = time.perf_counter()
    out = mag_localization.run(mag_localization.MagLocalizationConfig())
    _emit("mag_localization", t0, **out)
    _gate(out["gp"]["test_rmse"] < 4.0, "GP map test RMSE < 4.0")
    _gate(out["pf"]["final_err"] < 1.5, "PF final error < 1.5 m")


MESH_SHAPES = ((4, 1), (2, 2))      # (particles, map) mesh axes
MESH_N_P = (256, 4096)              # float32 filter rows
EXACT_N_P = 4096                    # float64 filter + smoother rows


def _mesh_problem(n_p, dtype):
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.workloads import dense_mag

    cfg = dense_mag.DenseMagConfig(n_particles=n_p, m_basis=125, n_laps=1,
                                   n_per_lap=12)
    data, y, model, potential, _, k, Q, R = dense_mag.build_problem(
        cfg, jax.random.PRNGKey(3))
    arrays = (data.dx, y, data.init_state, jnp.zeros(potential.n_lin),
              jnp.diag(k), Q, R)
    return (model,) + tuple(jnp.asarray(a, dtype) for a in arrays) \
        + (cfg.dt,)


def _mesh_rows(devs, n_p, dtype, with_smoother):
    """Sharded filter (and information-form smoother) on each mesh of
    ``MESH_SHAPES`` against the single-card run of the same problem and
    keys; prints one line per mesh and yields its fields."""
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.engines import (
        RBPFConfig,
        RBPSConfig,
        run_rbpf,
        run_rbps_information_form,
    )
    from rbslam_tpu.parallel import make_mesh

    common = _mesh_problem(n_p, dtype)
    rb_cfg = RBPFConfig(n_particles=n_p, resampling="systematic")
    ps_cfg = RBPSConfig(n_particles=n_p, n_sweeps=2)
    one = run_rbpf(jax.random.PRNGKey(0), *common, rb_cfg)
    if with_smoother:
        ps_one = run_rbps_information_form(jax.random.PRNGKey(1), *common,
                                           ps_cfg)
    for n_part, n_map in MESH_SHAPES:
        t0 = time.perf_counter()
        mesh = make_mesh(n_part, n_map, devices=devs[:4])
        res = run_rbpf(jax.random.PRNGKey(0), *common, rb_cfg, mesh=mesh)
        per_step = np.asarray(
            jnp.sum(res.ancestors != one.ancestors, axis=1))
        # ancestors[t] resamples into step t + 1
        first = int(np.argmax(per_step > 0)) if per_step.any() \
            else len(per_step)
        fields = dict(
            dtype=dtype, mesh=[n_part, n_map], N_P=n_p,
            n_lin=int(common[4].shape[0]), T=int(common[2].shape[0]),
            ancestors_differing_per_step=per_step,
            filter_traj_drift_before_first_flip=float(jnp.max(jnp.abs(
                res.traj_mean[:first + 1] - one.traj_mean[:first + 1]))),
            filter_traj_drift=float(jnp.max(jnp.abs(
                res.traj_mean - one.traj_mean))),
        )
        finite = bool(jnp.all(jnp.isfinite(res.logw)))
        if with_smoother:
            ps = run_rbps_information_form(jax.random.PRNGKey(1), *common,
                                           ps_cfg, mesh=mesh)
            fields.update(
                smoother_traj_drift=float(jnp.max(jnp.abs(
                    ps.XNK - ps_one.XNK))),
                smoother_map_drift=float(jnp.max(jnp.abs(
                    ps.XLK - ps_one.XLK))),
            )
            finite &= bool(jnp.all(jnp.isfinite(ps.XNK))
                           & jnp.all(jnp.isfinite(ps.XLK)))
        _emit("four_cards", t0, **fields)
        _gate(finite, f"finite sharded outputs {fields['mesh']} N_P={n_p}")
        yield fields


def phase_four_cards(devs):
    """Sharded engines over real 4x1 and 2x2 meshes vs the single card.

    A sharded run equals the single-card run only while every resampling
    draw picks the same ancestor. Partitioned reductions round
    differently; a comb point within that rounding of a CDF boundary
    picks another ancestor, and from there the runs differ as two Monte
    Carlo draws do. In float32 (the program's dtype) that happens about
    once per step at N_P=4096, on virtual CPU devices too. So:

    - float32 at the default matmul precision: the filter at N_P=256 and
      4096 is printed in full, and gated on finite outputs and
      trajectory drift < 1e-4 up to the first differing ancestor;
    - float64 at the highest matmul precision, where the rounding is far
      below any CDF gap: filter and information-form smoother at
      N_P=4096 get the whole-run checks of __graft_entry__ (equal
      ancestors, filter and smoother trajectory drift < 1e-4, smoother
      map drift < 1e-3). A fault in the particle or map partitioning
      fails these at any precision."""
    import jax

    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
    # every row runs and prints before any gate is read
    rows = [f for n_p in MESH_N_P
            for f in _mesh_rows(devs, n_p, "float32", False)]
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        exact = list(_mesh_rows(devs, EXACT_N_P, "float64", True))
    for fields in rows:
        _gate(fields["filter_traj_drift_before_first_flip"] < 1e-4,
              f"trajectory drift before the first flip {fields['mesh']}"
              f" N_P={fields['N_P']}")
    for fields in exact:
        what = f"{fields['mesh']} N_P={EXACT_N_P} float64"
        _gate(not fields["ancestors_differing_per_step"].any(),
              f"sharded ancestors equal the single card {what}")
        _gate(fields["filter_traj_drift"] < 1e-4,
              f"sharded filter trajectory drift < 1e-4 {what}")
        _gate(fields["smoother_traj_drift"] < 1e-4,
              f"sharded smoother trajectory drift < 1e-4 {what}")
        _gate(fields["smoother_map_drift"] < 1e-3,
              f"sharded smoother map drift < 1e-3 {what}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    # the package first: without it nothing is printed at all
    from rbslam_tpu.utils.cache import enable_compilation_cache

    devs, card = phase_device()
    enable_compilation_cache()
    if args.four_cards:
        phase_four_cards(devs)
    else:
        phase_kernel_parity()
        phase_dense_mag_reference()
        phase_factored_carry(card)
        phase_other_workloads()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
