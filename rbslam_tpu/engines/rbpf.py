"""Rao-Blackwellized particle filter — `lax.scan` over time, `vmap` over
particles.

Reproduces the semantics of the reference filter (src/particleFilter.m):
per step, (1) resample ancestors from the previous weights and propagate
the nonlinear states (:103-113), (2) per-particle log-weights from the
marginal innovation likelihood (:126-151), (3) log-sum-exp normalize
(:153-156), (4) per-particle Kalman measurement update of the map state
(:163-204). Differences by design:

- the three per-particle MATLAB loops become three batched/vmapped ops —
  the KF update is one [N_P, ny, nLin] x [N_P, nLin, nLin] einsum chain;
- ancestor indices are *stored* and the trajectory tensor is
  reconstructed once after the scan, replacing the O(T^2 N_P) in-place
  history shuffle (:117-118);
- resampling scheme is configurable (the reference is multinomial every
  step; systematic is the default-recommended option per BASELINE.json);
- noise comes from explicit PRNG keys;
- `P_mean` is the correct weighted accumulation; the reference assigns
  instead of accumulating inside its loop (:228-230) so only the last
  particle survives — we do not replicate that bug.

Both dense (conditionally linear) and sparse (conditionally linearized
EKF, NaN-masked) measurement paths are supported with static shapes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from ..math.linalg import acc_dtype, ess_from_logw, logsumexp_normalize
from ..models.base import DenseModel, SparseModel
from ..ops.kalman import (
    kalman_update_dense_batched,
    kalman_update_masked_batched,
)
from ..ops.resampling import resample_indices


class RBPFConfig(NamedTuple):
    n_particles: int
    resampling: str = "multinomial"   # reference default (tools/sample.m)
    jitter: float = 1e-3              # src/particleFilter.m:89
    joseph: bool = False
    store_trajectories: bool = True
    # KF update: "xla" (ops/kalman.py einsum chain on the full P) or
    # "lowrank" (the factored carry P = P_base - Wt^T Wt that writes only
    # ny factor rows per step; kernels/kf_update.py::kf_update_lowrank).
    # "lowrank" applies to dense models with ny <= 3.
    kf_kernel: str = "xla"
    # resample only when ESS <= ess_threshold * N, accumulating
    # log-weights in between; 1.0 = every step (reference semantics,
    # src/particleFilter.m:104-113)
    ess_threshold: float = 1.0
    # rebase period r of the low-rank factored path (kf_kernel=
    # "lowrank"): the covariance is carried as P_base - Wt^T Wt with
    # ny*r factor rows, and P_base is materialized once every r steps —
    # see kernels/kf_update.py::kf_update_lowrank
    lowrank_period: int = 8
    # storage dtype for the per-particle covariance carry; "bfloat16"
    # halves the dominant HBM traffic (contractions and the gather-CP
    # kernel still accumulate in f32). Fenced at n_lin > 256: the
    # repeated rank-ny downdates accumulate bf16 rounding across T and
    # destabilize the *filter* weights at reference scale (measured NaN
    # at n_lin=515, RESULTS.md); set allow_bf16_large_nl to override.
    cov_dtype: str = "float32"
    allow_bf16_large_nl: bool = False
    # distributed resampling mode under a mesh (parallel/resampling.py):
    # "replicated_cdf" / "prefix" are exact (index-for-index equal to
    # the single-device resampler); "local" is the O(1)-collective
    # island mode — children stay on their shard and carry the shard's
    # aggregate weight instead of the uniform reset (unbiased, not
    # draw-for-draw equal)
    dist_resampling: str = "replicated_cdf"
    # re-symmetrize P after every downdate (an extra HBM pass; the
    # reference filter does not, src/particleFilter.m:198 — fp drift is
    # surfaced by the chol_retries counter). XLA path only: the factored
    # carry keeps P_base symmetric by construction and ignores this flag.
    symmetrize_cov: bool = True


class RBPFResult(NamedTuple):
    traj_max: jnp.ndarray          # [T, n_nonlin] max-weight particle per step
    traj_mean: jnp.ndarray         # [T, n_nonlin] weighted mean per step
    xl_max: jnp.ndarray            # [n_lin] final max-weight map
    xl_mean: jnp.ndarray           # [n_lin] final weighted-mean map
    P_max: jnp.ndarray             # [n_lin, n_lin]
    P_mean: jnp.ndarray            # [n_lin, n_lin] (correct accumulation)
    traj_sample_iwmax: jnp.ndarray  # [T, n_nonlin] ancestral path of final best
    xn_traj: jnp.ndarray           # [T, N_P, n_nonlin] reconstructed trajectories
    xn_hist: jnp.ndarray           # [T, N_P, n_nonlin] raw per-step cloud
    ancestors: jnp.ndarray         # [T-1, N_P]
    logw: jnp.ndarray              # [N_P] final normalized log-weights
    xn: jnp.ndarray                # [N_P, n_nonlin] final particles
    xl: jnp.ndarray                # [N_P, n_lin] final maps
    P: jnp.ndarray                 # [N_P, n_lin, n_lin] final covariances
    ess: jnp.ndarray               # [T] effective sample size per step
    log_evidence: jnp.ndarray      # scalar: sum_t log(1/N sum w~)
    chol_retries: jnp.ndarray      # scalar: total jitter-retry count


def _broadcast_time(Q, dt, T):
    Q = jnp.asarray(Q)
    if Q.ndim == 2:
        Q = jnp.broadcast_to(Q, (T - 1,) + Q.shape)
    dt = jnp.asarray(dt)
    if dt.ndim == 0:
        dt = jnp.broadcast_to(dt, (T - 1,))
    return Q, dt


def _init_linear(x0_lin, P0_lin, n_particles):
    x0_lin = jnp.asarray(x0_lin)
    if x0_lin.ndim == 1:
        xl = jnp.broadcast_to(x0_lin, (n_particles,) + x0_lin.shape)
    else:
        # per-particle initial maps come as [n_lin, N_P] in the reference
        # (pfslam.m:91); accept [N_P, n_lin] here
        xl = x0_lin
    P = jnp.broadcast_to(
        jnp.asarray(P0_lin), (n_particles,) + jnp.asarray(P0_lin).shape
    )
    return xl, P


def reconstruct_trajectories(xn_hist, ancestors):
    """Rebuild per-particle ancestral trajectories.

    xn_hist: [T, N_P, dn] states as generated; ancestors: [T-1, N_P]
    (ancestors[t-1, i] = parent index of particle i at step t). Returns
    [T, N_P, dn] where column i is the full history of final particle i —
    the quantity the reference maintains by re-shuffling history every
    step (src/particleFilter.m:117-118).
    """
    T, n_p, _ = xn_hist.shape
    ident = jnp.arange(n_p, dtype=ancestors.dtype)

    def back(idx, a_t):
        idx_prev = a_t[idx]
        return idx_prev, idx_prev

    _, idx_hist = jax.lax.scan(back, ident, ancestors, reverse=True)
    # idx_hist[t] maps final-particle column -> index at step t (t < T-1)
    idx_full = jnp.concatenate([idx_hist, ident[None]], axis=0)  # [T, N_P]
    return jnp.take_along_axis(xn_hist, idx_full[:, :, None], axis=1)


def _measurement_update(model, xn, xl, P, y_t, R, mask_t, jitter, joseph,
                        symmetrize_out=True):
    """Vmapped weight + KF update for one time step; returns
    (xl', P', logw, retries)."""
    if isinstance(model, DenseModel):
        C = jax.vmap(model.meas_jacobian)(xn)            # [P, ny, nl]
        xl_new, P_new, logw, retried = kalman_update_dense_batched(
            C, P, xl, y_t, R, jitter, joseph, symmetrize_out
        )
    else:
        yhat, H = jax.vmap(model.measure)(xn, xl)        # [P, ny], [P, ny, nl]
        xl_new, P_new, logw, retried = kalman_update_masked_batched(
            yhat, H, P, xl, y_t, R, mask_t, jitter
        )
    return xl_new, P_new, logw, jnp.sum(retried)


def run_rbpf(
    key,
    model: Union[DenseModel, SparseModel],
    dx,
    y,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPFConfig,
    mask: Optional[jnp.ndarray] = None,
    mesh=None,
) -> RBPFResult:
    """Run the RBPF (see :func:`_run_rbpf` for the full contract).

    This thin eager wrapper validates, on CONCRETE inputs only, a
    contract the jitted body cannot check: the factored carry
    (kf_kernel="lowrank") has no observation-mask support, so NaN-masked
    dense measurements (measurement.m:56 semantics) would silently enter
    the update as y=0 observations.
    When y/mask are tracers (call sites inside an outer jit) the check
    is skipped — those callers own their masks.
    """
    kernel_path = config.kf_kernel != "xla"
    if kernel_path and not isinstance(y, jax.core.Tracer):
        if mask is not None and not isinstance(mask, jax.core.Tracer):
            if not bool(jnp.all(jnp.asarray(mask) != 0)):
                raise ValueError(
                    "kf_kernel='lowrank' does not support masked "
                    "observations; use kf_kernel='xla' (ops/kalman "
                    "masked path) for NaN/masked y"
                )
        elif mask is None and not bool(jnp.all(jnp.isfinite(y))):
            raise ValueError(
                "y contains NaN but kf_kernel='lowrank' is "
                "selected; NaN rows are only masked correctly on "
                "kf_kernel='xla' (ops/kalman.kalman_update_masked)"
            )
    if isinstance(model, SparseModel):
        # GPU f32 matmuls may run in TF32 (about three decimal digits)
        # at the default precision; the sparse/EKF masked algebra
        # (noise_var=0.1^2 against initMapVar=4^2, pfslam.m:78-93) is too
        # ill-conditioned for reduced-precision passes (NaN weights
        # mid-run at reference scale). The sparse shapes are tiny, so
        # full-f32 products cost nothing; the dense path keeps the
        # default.
        with jax.default_matmul_precision("highest"):
            return _run_rbpf(
                key, model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                config, mask, mesh,
            )
    return _run_rbpf(
        key, model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt, config,
        mask, mesh,
    )


@partial(
    jax.jit,
    static_argnames=("model", "config", "mesh"),
)
def _run_rbpf(
    key,
    model: Union[DenseModel, SparseModel],
    dx,
    y,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPFConfig,
    mask: Optional[jnp.ndarray] = None,
    mesh=None,
) -> RBPFResult:
    """Run the RBPF.

    dx: [T-1, n_u] odometry; y: [T, ny] observations (NaN allowed on the
    sparse path — converted to a mask); mask optionally overrides the
    NaN-derived visibility mask.

    mesh: optional ``jax.sharding.Mesh`` with a ``particles`` axis (and
    optionally a ``map`` axis for the covariance basis blocks). When
    given, the FULL filter — ancestors, trajectories, ESS gating,
    log-evidence — runs GSPMD-partitioned: sharding constraints are
    carried through the scan so every per-particle tensor stays
    distributed, resampling indices come from the explicit-collective
    sharded resampler (parallel/resampling.py), and the crossing-particle
    state exchange rides XLA's partitioned gather. Results equal the
    unsharded run (tests/test_sharding.py). The factored carry
    (kf_kernel="lowrank") is single-device and rejected under a mesh.
    """
    n_p = config.n_particles
    T = y.shape[0]
    if mesh is not None:
        if config.kf_kernel != "xla":
            raise ValueError(
                "kf_kernel='lowrank' is single-device; use kf_kernel='xla' "
                "with mesh"
            )
        from ..parallel.mesh import particle_map_sharding, particle_sharding
        from ..parallel.resampling import (
            sharded_resample_indices,
            sharded_resample_local,
        )

        from jax.sharding import PartitionSpec as _PS

        _shard_map_ax = mesh.shape.get("map", 1) > 1
        _P_sh = (
            particle_map_sharding(mesh, 3, 2)
            if _shard_map_ax
            else particle_sharding(mesh, 3)
        )
        _wsc = jax.lax.with_sharding_constraint

        def _mk_gather(pspec):
            """Explicit shard_map ancestor-state gather: all-gather the
            operand along `particles` ONLY (any map axis stays sharded)
            and index locally. GSPMD's inferred partition of the same
            `jnp.take` hits an involuntary-full-rematerialization (it
            replicates across BOTH mesh axes then repartitions —
            spmd_partitioner warning); this form pins
            the exchange to one particles-axis all_gather."""
            def inner(x_l, ai_l):
                x_all = jax.lax.all_gather(
                    x_l, "particles", axis=0, tiled=True
                )
                return jnp.take(x_all, ai_l, axis=0)

            def g(x, ai):
                return jax.shard_map(
                    inner, mesh=mesh,
                    in_specs=(pspec, _PS("particles")),
                    out_specs=pspec, check_vma=False,
                )(x, ai)
            return g

        _take_state = _mk_gather(_PS("particles", None))
        _take_P = _mk_gather(
            _PS("particles", None, "map") if _shard_map_ax
            else _PS("particles", None, None)
        )

        def constrain(xn, xl, P, logw):
            return (
                _wsc(xn, particle_sharding(mesh, 2)),
                _wsc(xl, particle_sharding(mesh, 2)),
                _wsc(P, _P_sh),
                _wsc(logw, particle_sharding(mesh, 1)),
            )

        if config.dist_resampling == "local":
            def _resample(k, w):
                return sharded_resample_local(k, w, mesh, config.resampling)
        else:
            def _resample(k, w):
                ai = sharded_resample_indices(
                    k, w, mesh, config.resampling, config.dist_resampling
                )
                return ai, jnp.full((n_p,), -jnp.log(n_p), w.dtype)
    else:
        def constrain(xn, xl, P, logw):
            return xn, xl, P, logw

        def _resample(k, w):
            ai = resample_indices(k, w, n_p, config.resampling)
            return ai, jnp.full((n_p,), -jnp.log(n_p), w.dtype)

        def _take_state(x, ai):
            return jnp.take(x, ai, axis=0)

        _take_P = _take_state
    if config.kf_kernel not in ("xla", "lowrank"):
        raise ValueError(
            f"unknown kf_kernel {config.kf_kernel!r}: expected 'xla' or "
            "'lowrank'"
        )
    lowrank = (
        config.kf_kernel == "lowrank"
        and isinstance(model, DenseModel)
        and model.ny <= 3
        # T == 1 has zero scan steps: route through the generic scan
        # (which never runs an update at length 0) instead of the
        # nested-period machinery, whose empty outs_parts cannot concat
        and T > 1
    )
    y = jnp.asarray(y)
    if mask is None:
        mask = jnp.isfinite(y).astype(y.dtype)
    y = jnp.nan_to_num(y)
    Q, dt = _broadcast_time(Q, dt, T)
    R = jnp.asarray(R)

    xn0 = jnp.broadcast_to(
        jnp.asarray(x0_nonlin), (n_p,) + jnp.asarray(x0_nonlin).shape
    )
    xl0, P0 = _init_linear(x0_lin, P0_lin, n_p)
    n_lin = xl0.shape[-1]
    if config.cov_dtype != "float32":
        if (config.cov_dtype == "bfloat16" and n_lin > 256
                and not config.allow_bf16_large_nl
                and not lowrank):
            # the per-step paths round the FULL covariance to bf16 every
            # step: the rounding accumulates over T and produces NaN
            # weights at reference scale (seen at n_lin=515, RESULTS.md).
            # The lowrank factored carry is exempt — it rounds P only at
            # rebases (T/r times, factor rows exact within a period) and
            # stays accurate at n_lin=512/T=192 (RESULTS.md).
            raise ValueError(
                f"cov_dtype='bfloat16' at n_lin={n_lin} > 256 destabilizes "
                "the per-step filter paths (bf16 rounding of the "
                "covariance downdates accumulates over T and produces NaN "
                "weights at reference scale — RESULTS.md). Use float32, "
                "kf_kernel='lowrank' (rounds P only at rebases; measured "
                "stable at this scale), or set allow_bf16_large_nl=True "
                "to override deliberately."
            )
        P0 = P0.astype(jnp.dtype(config.cov_dtype))

    # --- step t = 0: no prediction (src/particleFilter.m:103) ---
    key, k0 = jax.random.split(key)
    xl1, P1, logw1, retries0 = _measurement_update(
        model, xn0, xl0, P0, y[0], R, mask[0], config.jitter,
        config.joseph, config.symmetrize_cov,
    )
    w1, logw1n, logz0 = logsumexp_normalize(logw1)

    def step(carry, inputs):
        xn, xl, P, logw_n, retries = carry
        k, y_t, mask_t, u, Q_t, dt_t = inputs
        k_res, k_dyn = jax.random.split(k)

        w = jnp.exp(logw_n)
        if config.ess_threshold >= 1.0:
            ai, logw_prev = _resample(k_res, w)
            do_res = None
        else:
            ess_prev = ess_from_logw(logw_n)
            do_res = ess_prev <= config.ess_threshold * n_p
            ident = jnp.arange(n_p, dtype=jnp.int32)
            # single-branch cond: skip the cumsum+searchsorted on
            # non-resampling steps
            ai, logw_prev = jax.lax.cond(
                do_res,
                lambda ww: _resample(k_res, ww),
                lambda ww: (ident, logw_n),
                w,
            )
        xn_anc = _take_state(xn, ai)
        xl_anc = _take_state(xl, ai)

        if getattr(model, "dynamics_batch", None) is not None:
            xn_new = model.dynamics_batch(k_dyn, xn_anc, u, dt_t, Q_t)
        else:
            dyn_keys = jax.random.split(k_dyn, n_p)
            xn_new = jax.vmap(
                lambda kk, x: model.dynamics(kk, x, u, dt_t, Q_t)
            )(dyn_keys, xn_anc)

        if do_res is None:
            P_anc = _take_P(P, ai)
        else:
            # ESS-adaptive: the P gather is the dominant HBM cost of a
            # step — execute it only on resampling steps (lax.cond runs a
            # single branch, unlike a select)
            P_anc = jax.lax.cond(
                do_res, lambda p: _take_P(p, ai),
                lambda p: p, P,
            )
        xl_new, P_new, logw, retried = _measurement_update(
            model, xn_new, xl_anc, P_anc, y_t, R, mask_t,
            config.jitter, config.joseph, config.symmetrize_cov,
        )
        logw = logw_prev + jnp.log(n_p) + logw  # accumulate (no-op at thr=1)
        w_new, logw_nn, logz = logsumexp_normalize(logw)
        xn_new, xl_new, P_new, logw_nn = constrain(
            xn_new, xl_new, P_new, logw_nn
        )

        iw_max = jnp.argmax(logw_nn)
        outs = (
            xn_new if config.store_trajectories else jnp.zeros((0,)),
            ai.astype(jnp.int32),
            logw_nn,
            xn_new[iw_max],
            jnp.sum(xn_new * w_new[:, None], axis=0),
            ess_from_logw(logw_nn),
            logz - jnp.log(n_p),
        )
        return (xn_new, xl_new, P_new, logw_nn, retries + retried), outs

    step_keys = jax.random.split(key, T - 1)
    xn0c, xl1, P1, logw1n = constrain(xn0, xl1, P1, logw1n)
    if lowrank:
        # --- low-rank factored covariance scan ---------------------------
        # Nested scans keep P_base out of the inner carry so it is never
        # copied on non-rebase steps: the outer scan advances one rebase
        # period r (inner scan over r phases, P_base closed over
        # read-only), materializes P_base' = P_base[bidx] - Wt^T Wt once,
        # and resets the factor. The T-1 steps split into n_super full
        # periods plus one shorter remainder scan (same inner body) —
        # no per-step validity masking, no lax.cond around the large
        # carry. Semantics identical to the xla path
        # (src/particleFilter.m:104-204), tested in tests/test_fused_kf.py.
        from ..kernels.kf_update import kf_rebase, kf_update_lowrank

        r = config.lowrank_period
        ny = model.ny
        rw = ny * r
        n_super = (T - 1) // r
        rem = (T - 1) - n_super * r

        def lowrank_inner(P_base):
            def inner(carry, inp):
                xn, xl, Wt, bidx, logw_n, retries = carry
                k, y_t, u, Q_t, dt_t, phase = inp
                k_res, k_dyn = jax.random.split(k)
                w = jnp.exp(logw_n)
                if config.ess_threshold >= 1.0:
                    ai, logw_prev = _resample(k_res, w)
                    xn_a = jnp.take(xn, ai, axis=0)
                    xl_a = jnp.take(xl, ai, axis=0)
                    bidx_n = jnp.take(bidx, ai, axis=0)
                    Wt_g = jnp.take(Wt, ai, axis=0)
                else:
                    # ESS-gated: a no-resample step keeps ai = identity,
                    # composing cleanly with the carried base indices
                    # (the P_base gather just re-reads each particle's
                    # own row); all state gathers are skipped
                    # inside the single-branch cond
                    ess_prev = ess_from_logw(logw_n)
                    do_res = ess_prev <= config.ess_threshold * n_p
                    ident = jnp.arange(n_p, dtype=jnp.int32)
                    ai, logw_prev = jax.lax.cond(
                        do_res,
                        lambda ww: _resample(k_res, ww),
                        lambda ww: (ident, logw_n),
                        w,
                    )
                    xn_a, xl_a, bidx_n, Wt_g = jax.lax.cond(
                        do_res,
                        lambda o: tuple(jnp.take(x, ai, axis=0) for x in o),
                        lambda o: o,
                        (xn, xl, bidx, Wt),
                    )
                if getattr(model, "dynamics_batch", None) is not None:
                    xn_new = model.dynamics_batch(k_dyn, xn_a, u, dt_t, Q_t)
                else:
                    dyn_keys = jax.random.split(k_dyn, n_p)
                    xn_new = jax.vmap(
                        lambda kk, x: model.dynamics(kk, x, u, dt_t, Q_t)
                    )(dyn_keys, xn_a)
                C = jax.vmap(model.meas_jacobian)(xn_new).astype(
                    P_base.dtype
                )
                xl_new, wnew, logw, retried_b = kf_update_lowrank(
                    bidx_n, C, xl_a, Wt_g, P_base, y_t, R, config.jitter
                )
                # place the new factor rows at [ny*phase, ny*phase+ny):
                # the target rows are always still zero (each phase owns
                # distinct rows, gathers permute particles not rows), so
                # an add of E(phase) @ wnew is exact and fuses with the
                # slab handling instead of a dynamic_update_slice copy
                rw_here = Wt_g.shape[1]
                E = (
                    jnp.arange(rw_here)[:, None]
                    == ny * phase + jnp.arange(ny)[None, :]
                ).astype(Wt_g.dtype)
                Wt_new = Wt_g + jnp.einsum(
                    "rc,pcn->prn", E, wnew.astype(Wt_g.dtype)
                )
                # accumulate carried log-weights (a no-op at
                # ess_threshold=1, where logw_prev = -log N_P)
                logw = logw_prev + jnp.log(n_p) + logw
                w_new, logw_nn, logz = logsumexp_normalize(logw)
                iw_max = jnp.argmax(logw_nn)
                outs = (
                    xn_new if config.store_trajectories
                    else jnp.zeros((0,)),
                    ai.astype(jnp.int32),
                    logw_nn,
                    xn_new[iw_max],
                    jnp.sum(xn_new * w_new[:, None], axis=0),
                    ess_from_logw(logw_nn),
                    logz - jnp.log(n_p),
                )
                carry = (xn_new, xl_new, Wt_new, bidx_n, logw_nn,
                         retries + jnp.sum(retried_b))
                return carry, outs
            return inner

        def run_period(carry, inp_r, width):
            xn, xl, P_base, logw_n, retries = carry
            Wt0 = jnp.zeros((n_p, width, n_lin), P_base.dtype)
            bidx0 = jnp.arange(n_p, dtype=jnp.int32)
            (xn, xl, Wt, bidx, logw_n, retries), outs = jax.lax.scan(
                lowrank_inner(P_base),
                (xn, xl, Wt0, bidx0, logw_n, retries), inp_r,
            )
            P_base = kf_rebase(bidx, Wt, P_base)
            return (xn, xl, P_base, logw_n, retries), outs

        carry = (xn0c, xl1, P1, logw1n, retries0)
        outs_parts = []
        if n_super > 0:
            nmain = n_super * r
            phases = jnp.broadcast_to(
                jnp.arange(r, dtype=jnp.int32), (n_super, r)
            )

            def reshape_main(a):
                return a[:nmain].reshape((n_super, r) + a.shape[1:])

            inp_main = (
                reshape_main(step_keys), reshape_main(y[1:]),
                reshape_main(dx), reshape_main(Q), reshape_main(dt),
                phases,
            )
            carry, outs_main = jax.lax.scan(
                lambda c, i: run_period(c, i, rw), carry, inp_main
            )
            outs_parts.append(jax.tree_util.tree_map(
                lambda a: a.reshape((nmain,) + a.shape[2:]), outs_main
            ))
        if rem > 0:
            s = n_super * r
            inp_rem = (
                step_keys[s:], y[1 + s:], dx[s:], Q[s:], dt[s:],
                jnp.arange(rem, dtype=jnp.int32),
            )
            carry, outs_rem = run_period(carry, inp_rem, ny * rem)
            outs_parts.append(outs_rem)
        xn_f, xl_f, P_f, logw_f, total_retries = carry
        outs = jax.tree_util.tree_map(
            lambda *a: jnp.concatenate(a, axis=0), *outs_parts
        )
    else:
        inputs = (step_keys, y[1:], mask[1:], dx, Q, dt)
        carry0 = (xn0c, xl1, P1, logw1n, retries0)
        (xn_f, xl_f, P_f, logw_f, total_retries), outs = jax.lax.scan(
            step, carry0, inputs
        )
    xn_hist, ancestors, logw_hist, traj_max_t, traj_mean_t, ess_t, logz_t = outs

    # prepend step-0 outputs
    iw0 = jnp.argmax(logw1n)
    traj_max = jnp.concatenate(
        [xn0[iw0][None], traj_max_t], axis=0
    )
    traj_mean = jnp.concatenate(
        [jnp.sum(xn0 * w1[:, None], axis=0)[None], traj_mean_t], axis=0
    )
    ess = jnp.concatenate([ess_from_logw(logw1n)[None], ess_t])
    log_evidence = (logz0 - jnp.log(n_p)) + jnp.sum(logz_t)

    if config.store_trajectories:
        xn_hist_full = jnp.concatenate(
            [xn0[None], xn_hist], axis=0
        )  # [T, P, dn]
        xn_traj = reconstruct_trajectories(xn_hist_full, ancestors)
    else:
        # store_trajectories=False: the [T, N_P, dn] history tensors are
        # the marginal memory cost at large N_P; production-scale
        # runs that only need the per-step estimates skip them.
        # Ancestors are still returned — reconstruct offline if needed.
        xn_hist_full = jnp.zeros((0,), y.dtype)
        xn_traj = jnp.zeros((0,), y.dtype)

    if config.store_trajectories:
        P_f = P_f.astype(jnp.float32)
    # else: Result.P stays in the covariance storage dtype — the f32
    # materialization of the full [N, nl, nl] ensemble is another
    # N*nl*nl*4 bytes of peak HBM, exactly what
    # the large-ensemble no-history mode exists to avoid; the summary
    # outputs below are f32 regardless
    w_f = jnp.exp(logw_f)
    iw_max = jnp.argmax(logw_f)
    xl_mean = jnp.sum(xl_f * w_f[:, None], axis=0)
    dev = xl_mean[None, :] - xl_f
    P_mean = jnp.einsum(
        "p,pij->ij", w_f.astype(P_f.dtype), P_f,
        preferred_element_type=acc_dtype(P_f),
    ) + jnp.einsum("p,pi,pj->ij", w_f, dev, dev)
    P_max_out = P_f[iw_max].astype(jnp.float32)

    return RBPFResult(
        traj_max=traj_max,
        traj_mean=traj_mean,
        xl_max=xl_f[iw_max],
        xl_mean=xl_mean,
        P_max=P_max_out,
        P_mean=P_mean,
        traj_sample_iwmax=(
            xn_traj[:, iw_max] if config.store_trajectories else xn_traj
        ),
        xn_traj=xn_traj,
        xn_hist=xn_hist_full,
        ancestors=ancestors,
        logw=logw_f,
        xn=xn_f,
        xl=xl_f,
        P=P_f,
        ess=ess,
        log_evidence=log_evidence,
        chol_retries=total_retries,
    )
