"""Information-form RBPS: the scalable ancestor-weight computation.

Identical smoother to engines/rbps.py, but the future-measurement
ancestor weights are computed in information form
(src/particleSmootherInformationForm.m): per particle maintain

    ivec = P0^-1 x0 + sum_j C_j' R^-1 y_j,
    Imat = P0^-1    + sum_j C_j' R^-1 C_j,
    halfLogDetP (recursed through the KF: :298)

and once per sweep pre-accumulate the whole-trajectory suffix pair
(ivecAdd, ImatAdd) along the reference (:132-146), downdating one term
per time step (:194-201). The ancestor weight then costs one
n_lin^3 Cholesky per particle independent of T (:224-236):

    logwMeas = -1/2 ivec' P ivec - halfLogDetP
               - sum log diag chol(ImatEnd) + 1/2 ||chol^-1 ivecEnd||^2

Dense features only, like the reference (:77-80). Importance weights and
KF updates use the standard innovation form (mathematically equal to the
reference's information-form weight :301-304, and cheaper since the KF
factorizes S anyway).

Like the reference (:110-113), P0_lin is assumed diagonal when forming
the initial information pair.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..math.linalg import (
    acc_dtype,
    half_logdet,
    logsumexp_normalize,
    psd_cholesky,
    tril_solve,
)
from ..models.base import DenseModel
from ..ops.resampling import resample_indices, sample_categorical
from .rbpf import (
    _broadcast_time,
    _init_linear,
    reconstruct_trajectories,
)
from .rbps import RBPSConfig, RBPSResult, _dyn_log_weights


def _info_future_log_weights(ivec, Imat, P, halfLogDetP, ivec_add, Imat_add, jitter):
    """Ancestor measurement weights, information form (:224-236), batched
    over the ensemble (one [N, nl, nl] Cholesky; storage dtypes are
    promoted to at least f32 for the factorization)."""
    # no symmetrize: cholesky reads only the lower triangle, so the fp
    # asymmetry of the accumulated information pair is irrelevant here
    Imat_end = Imat.astype(acc_dtype(Imat)) + Imat_add[None]
    L, retried = psd_cholesky(Imat_end, jitter)
    v = tril_solve(L, ivec + ivec_add[None])
    Pv = jnp.einsum(
        "pij,pj->pi", P, ivec, preferred_element_type=acc_dtype(P, ivec)
    )
    quad0 = jnp.sum(ivec * Pv, axis=-1)
    logw = (
        -0.5 * quad0
        - halfLogDetP
        - half_logdet(L)
        + 0.5 * jnp.sum(v * v, axis=-1)
    )
    return logw, retried


def _woodbury_rank_ny(W, hldM, U, sign: float, jitter):
    """Exact rank-ny update of (W = M^-1, hldM = 0.5 log|M|) under
    M' = M + sign * U U' (sign = +1 update / -1 downdate).

        W'    = W - sign * G Bpos^-1 G',   G = W U,
        Bpos  = I + sign * U' G            (SPD in both directions
                                            while M' stays SPD),
        hldM' = hldM + 0.5 log|Bpos|.

    U: [N, nl, ny]. This is the O(nl^2 ny) alternative to re-factorizing
    Imat+ImatAdd per step (RBPSConfig.ancestor_form="woodbury") with
    XLA's batched nl^3 cholesky + triangular solve. Returns (W', hldM',
    retried).
    """
    from ..ops.kalman import (
        _chol_small_batched,
        _inv_from_chol_small_batched,
    )

    ny = U.shape[-1]
    acc = acc_dtype(W, U)
    G = jnp.einsum("pij,pjk->pik", W, U, preferred_element_type=acc)
    Bpos = jnp.eye(ny, dtype=acc) + sign * jnp.einsum(
        "pji,pjk->pik", U, G, preferred_element_type=acc
    )
    if ny <= 3:
        L, retried = _chol_small_batched(Bpos, jitter)
        Binv = _inv_from_chol_small_batched(L)
    else:
        L, retried = psd_cholesky(Bpos, jitter)
        Binv = jax.vmap(
            lambda Li: jax.scipy.linalg.cho_solve(
                (Li, True), jnp.eye(ny, dtype=W.dtype)
            )
        )(L)
    hldM_new = hldM + jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    GB = jnp.einsum("pik,pkl->pil", G, Binv)
    # rank-ny correction as a SUM OF BROADCAST OUTER PRODUCTS, not a
    # thin-K matmul: XLA lowers the K=ny einsum as a convolution whose
    # [N, nl, nl] output takes a transposed layout, forcing a full
    # layout-copy pass before the subtract (scripts/trace_smoother.py);
    # the broadcast form is elementwise (layout-agnostic) and fuses
    # with the subtract into one output pass. Compute is ny MACs per
    # element — negligible next to the memory traffic either way.
    corr = sum(
        GB[..., l][:, :, None] * G[..., l][:, None, :]
        for l in range(ny)
    )
    W_new = W - (sign * corr).astype(W.dtype)
    return W_new, hldM_new, retried


def _woodbury_future_log_weights(ivec, W, P, hldp, hldM, ivec_add):
    """Ancestor measurement weights from the maintained inverse:
    identical to :func:`_info_future_log_weights` with chol(Imat_end)
    replaced by (W, hldM) — logw = -1/2 ivec'P ivec - hldp - hldM
    + 1/2 (ivec+ivecAdd)' W (ivec+ivecAdd)."""
    ivec_end = ivec + ivec_add[None]
    Wv = jnp.einsum("pij,pj->pi", W, ivec_end,
                    preferred_element_type=acc_dtype(W, ivec_end))
    quadW = jnp.sum(ivec_end * Wv, axis=-1)
    Pv = jnp.einsum(
        "pij,pj->pi", P, ivec, preferred_element_type=acc_dtype(P, ivec)
    )
    quad0 = jnp.sum(ivec * Pv, axis=-1)
    return -0.5 * quad0 - hldp - hldM + 0.5 * quadW


def _kf_info_update_batched(C, P, xl, ivec, Imat, hldp, y_t, R, Rinv,
                            half_logdet_R, jitter, joseph,
                            symmetrize_out=True, update_imat=True):
    """Whole-ensemble KF update + information-pair update (:316-335) and
    halfLogDetP recursion (:298). C [N,ny,nl]; P/Imat may be stored in a
    reduced dtype (accumulation stays f32). ``update_imat=False`` passes
    the Imat slot through untouched (the Woodbury ancestor form carries
    W there and maintains it separately). Returns
    (xl', P', ivec', Imat', hldp', logw, retried)."""
    from ..ops.kalman import kalman_update_dense_batched_hld

    xl_new, P_new, logw, retried, hld_S = kalman_update_dense_batched_hld(
        C, P, xl, y_t, R, jitter, joseph, symmetrize_out
    )
    CtRinv = jnp.einsum("pki,kl->pil", C, Rinv)          # [N, nl, ny]
    ivec_new = ivec + jnp.einsum("pil,l->pi", CtRinv, y_t)
    if update_imat:
        dI = jnp.einsum(
            "pil,plj->pij", CtRinv, C,
            preferred_element_type=acc_dtype(CtRinv, C),
        )
        Imat_new = Imat + dI.astype(Imat.dtype)
    else:
        Imat_new = Imat
    # halfLogDetP' = -sum log diag chol(S) + 0.5 log|R| + halfLogDetP
    hldp_new = -hld_S + half_logdet_R + hldp
    return xl_new, P_new, ivec_new, Imat_new, hldp_new, logw, retried


@partial(jax.jit, static_argnames=("model", "config", "is_first", "mesh"))
def _info_sweep(
    key,
    model: DenseModel,
    dx,
    y,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPSConfig,
    xnk,
    is_first: bool,
    mesh=None,
):
    n_p = config.n_particles
    T, ny = y.shape
    R = jnp.asarray(R)
    Rinv = jnp.linalg.inv(R)

    if mesh is not None:
        # GSPMD multi-chip: ensemble tensors shard their particle axis;
        # the [N, nl, nl] covariance / information matrices additionally
        # shard a basis-block axis over the ``map`` mesh axis (the
        # "map-axis model parallelism" of SURVEY §2.4). XLA inserts the
        # psum/all-gather collectives (weight normalization, the nl^3
        # ancestor-weight Cholesky) from these constraints.
        from ..parallel.mesh import particle_map_sharding, particle_sharding

        shard_map = mesh.shape.get("map", 1) > 1
        _mat_sh = (
            particle_map_sharding(mesh, 3, 2)
            if shard_map
            else particle_sharding(mesh, 3)
        )

        def _constrain(xn, xl, P, ivec, Imat, hldp, logw):
            wsc = jax.lax.with_sharding_constraint
            return (
                wsc(xn, particle_sharding(mesh, 2)),
                wsc(xl, particle_sharding(mesh, 2)),
                wsc(P, _mat_sh),
                wsc(ivec, particle_sharding(mesh, 2)),
                wsc(Imat, _mat_sh),
                wsc(hldp, particle_sharding(mesh, 1)),
                wsc(logw, particle_sharding(mesh, 1)),
            )
    else:
        # (tried: jax.experimental.layout.with_layout_constraint row-
        # major pins on the P/W carries to kill the per-step layout
        # copies the trace shows — the copies just moved to the other
        # side of the gathers, throughput unchanged; the residual
        # {1,2,0} demand is XLA's layout choice for one ancestor
        # gather, not the carries. scripts/trace_smoother.py)
        def _constrain(*args):
            return args

    xn0 = jnp.broadcast_to(
        jnp.asarray(x0_nonlin), (n_p,) + jnp.asarray(x0_nonlin).shape
    )
    if not is_first:
        xn0 = xn0.at[n_p - 1].set(xnk[0])
    xl0, P0 = _init_linear(x0_lin, P0_lin, n_p)

    # initial information pair; P0 treated as diagonal (:110-115)
    p0_diag = jnp.diagonal(jnp.asarray(P0_lin))
    Imat0_single = jnp.diag(1.0 / p0_diag)
    ivec0 = xl0 / p0_diag[None, :]
    Imat0 = jnp.broadcast_to(Imat0_single, (n_p,) + Imat0_single.shape)
    hldp0 = jnp.full((n_p,), 0.5 * jnp.sum(jnp.log(p0_diag)), dtype=y.dtype)
    if config.cov_dtype != "float32":
        cd = jnp.dtype(config.cov_dtype)
        P0 = P0.astype(cd)
        Imat0 = Imat0.astype(cd)
    half_logdet_R = 0.5 * jnp.linalg.slogdet(R)[1]

    precomp = config.suffix_precompute and not is_first
    if not is_first:
        C_ref = jax.vmap(model.meas_jacobian)(xnk)      # [T, ny, n_lin]
        # whole-trajectory suffix pair (:132-146)
        terms_iv = jnp.einsum("tik,ij,tj->tk", C_ref, Rinv, y)
        ivec_add0 = jnp.sum(terms_iv, axis=0)
        Imat_add0 = jnp.einsum("tki,kl,tlj->ij", C_ref, Rinv, C_ref)
        if precomp:
            # suffix sums for every t at once — one reverse cumulative
            # (associative) scan per sweep instead of T sequential
            # downdates; ivec_adds[t] = sum_{j>=t} C_j'R^-1 y_j
            ivec_adds = jnp.flip(
                jnp.cumsum(jnp.flip(terms_iv, 0), axis=0), 0
            )
            if config.ancestor_form != "woodbury":
                terms_im = jnp.einsum(
                    "tki,kl,tlj->tij", C_ref, Rinv, C_ref
                )
                Imat_adds = jnp.flip(
                    jnp.cumsum(jnp.flip(terms_im, 0), axis=0), 0
                )
    else:
        C_ref = jnp.zeros((T, ny, model.n_lin), dtype=y.dtype)
        ivec_add0 = jnp.zeros((model.n_lin,), dtype=y.dtype)
        Imat_add0 = jnp.zeros((model.n_lin, model.n_lin), dtype=y.dtype)

    # Woodbury ancestor form: carry W = (Imat+ImatAdd)^-1 in the Imat
    # slot and hldM = 0.5 log|Imat+ImatAdd| alongside, maintained by
    # exact rank-ny transitions instead of per-step factorizations
    use_wood = (config.ancestor_form == "woodbury") and (not is_first)
    RiT = jnp.linalg.inv(jnp.linalg.cholesky(R)).T     # U = C' L_R^-T

    def meas_all(xn, xl, P, ivec, Imat, hldp, y_t):
        C = jax.vmap(model.meas_jacobian)(xn)
        out = _kf_info_update_batched(
            C, P, xl, ivec, Imat, hldp, y_t, R, Rinv, half_logdet_R,
            config.jitter, config.joseph, config.symmetrize_cov,
            update_imat=not use_wood,
        )
        return (C,) + out

    # t = 0
    C0, xl1, P1, ivec1, Imat1, hldp1, logw1, retried0 = meas_all(
        xn0, xl0, P0, ivec0, Imat0, hldp0, y[0]
    )
    _, logw1n, _ = logsumexp_normalize(logw1)

    n_lin = model.n_lin
    if use_wood:
        # W(1) = (Imat(0 post) + ImatAdd_[1:T))^-1. All xn0 rows are the
        # broadcast initial state except the pinned reference particle,
        # so TWO nl x nl factorizations cover the whole ensemble.
        C2 = jnp.stack([C0[0], C0[n_p - 1]])           # [2, ny, nl]
        D2 = jnp.einsum("pki,kl,plj->pij", C2, Rinv, C2)
        Add1 = Imat_add0 - C_ref[0].T @ Rinv @ C_ref[0]
        M2 = jnp.diag(1.0 / p0_diag)[None] + D2 + Add1[None]
        if mesh is not None:
            # pin the TWO-matrix factorization replicated: with the map
            # sharding it inherits from Imat_add0, the blocked Cholesky's
            # internal gathers are the ops GSPMD could only partition by
            # involuntary full rematerialization (spmd_partitioner warning);
            # at [2, nl, nl] the replicated factorization is negligible
            from jax.sharding import NamedSharding, PartitionSpec

            M2 = jax.lax.with_sharding_constraint(
                M2, NamedSharding(mesh, PartitionSpec())
            )
        L2, retried_w1 = psd_cholesky(M2, config.jitter)
        eye_nl = jnp.eye(n_lin, dtype=y.dtype)
        W2 = jax.vmap(
            lambda Li: jax.scipy.linalg.cho_solve((Li, True), eye_nl)
        )(L2)
        # diagonal via masked reduce, not jnp.diagonal: the diagonal
        # gather of the map-axis-sharded [2, nl, nl] factor is the
        # f32[2,nl] gather GSPMD could only partition by involuntary
        # full rematerialization (spmd_partitioner warning)
        diag2 = jnp.sum(L2 * eye_nl[None], axis=-1)        # [2, nl]
        hld2 = jnp.sum(jnp.log(diag2), -1)
        # broadcast the two solutions over the ensemble with a SELECT,
        # not a gather: a take from the [2, nl, nl] map-sharded source
        # into the particles-sharded ensemble is the gather GSPMD could
        # only partition by involuntary full rematerialization
        # (spmd_partitioner warning); the select
        # partitions trivially on both mesh axes
        is_ref = (jnp.arange(n_p) == n_p - 1)
        Imat1 = jnp.where(is_ref[:, None, None], W2[1][None], W2[0][None])
        if config.cov_dtype != "float32":
            Imat1 = Imat1.astype(jnp.dtype(config.cov_dtype))
        hldM1 = jnp.where(is_ref, hld2[1], hld2[0])
    else:
        retried_w1 = jnp.zeros((), bool)
        hldM1 = jnp.zeros((n_p,), dtype=y.dtype)

    def step(carry, inputs):
        (xn, xl, P, ivec, Imat, hldp, hldM, logw_n, ivec_add, Imat_add,
         retries) = carry
        if precomp:
            k, y_t, u, Q_t, dt_t, t_idx, sfx_iv_t, sfx_im_t = inputs
        else:
            k, y_t, u, Q_t, dt_t, t_idx = inputs
        k_res, k_dyn, k_anc = jax.random.split(k, 3)

        w = jnp.exp(logw_n)
        ai = resample_indices(k_res, w, n_p, config.resampling)

        if is_first:
            anc_last = ai[n_p - 1]
            retries_anc = jnp.zeros((), retries.dtype)
        else:
            if precomp:
                ivec_add = sfx_iv_t
                if not use_wood:
                    Imat_add = sfx_im_t
            else:
                # downdate the suffix pair by the (t-1) term (:194-201)
                C_prev = C_ref[t_idx - 1]
                CtRinv_prev = C_prev.T @ Rinv
                ivec_add = ivec_add - CtRinv_prev @ y[t_idx - 1]
                Imat_add = Imat_add - CtRinv_prev @ C_prev

            logw_dyn = _dyn_log_weights(model, xnk[t_idx], xn, u, dt_t, Q_t)
            if use_wood:
                logw_meas = _woodbury_future_log_weights(
                    ivec, Imat, P, hldp, hldM, ivec_add
                )
                retried = jnp.zeros((n_p,), bool)
            else:
                logw_meas, retried = _info_future_log_weights(
                    ivec, Imat, P, hldp, ivec_add, Imat_add, config.jitter
                )
            pa_log = logw_n + logw_dyn + logw_meas
            pa, _, _ = logsumexp_normalize(pa_log)
            anc_last = sample_categorical(k_anc, pa)
            retries_anc = jnp.sum(retried)

        ai = ai.at[n_p - 1].set(anc_last)
        xn_anc = jnp.take(xn, ai, axis=0)
        gather = lambda a: jnp.take(a, ai, axis=0)
        xl_a, P_a, ivec_a, Imat_a, hldp_a, hldM_a = map(
            gather, (xl, P, ivec, Imat, hldp, hldM)
        )

        if getattr(model, "dynamics_batch", None) is not None:
            # one batched noise draw instead of N_P per-particle key
            # splits + vmapped small lax.linalg factorizations (the
            # filter's pattern; same distribution, different stream)
            xn_new = model.dynamics_batch(k_dyn, xn_anc, u, dt_t, Q_t)
        else:
            dyn_keys = jax.random.split(k_dyn, n_p)
            xn_new = jax.vmap(
                lambda kk, x: model.dynamics(kk, x, u, dt_t, Q_t)
            )(dyn_keys, xn_anc)
        if not is_first:
            xn_new = xn_new.at[n_p - 1].set(xnk[t_idx])

        C_t, xl_new, P_new, ivec_new, Imat_new, hldp_new, logw, retried_kf = (
            meas_all(xn_new, xl_a, P_a, ivec_a, Imat_a, hldp_a, y_t)
        )
        hldM_new = hldM_a
        retries_w = jnp.zeros((), retries.dtype)
        if use_wood:
            # W: M(t) -> M(t+1) = M(t) + C_t' R^-1 C_t - C_ref' R^-1 C_ref
            U = jnp.einsum("pki,km->pim", C_t, RiT)
            Imat_new, hldM_new, r_u = _woodbury_rank_ny(
                Imat_new, hldM_new, U, 1.0, config.jitter
            )
            Vb = jnp.broadcast_to(
                (C_ref[t_idx].T @ RiT)[None], (n_p, model.n_lin, ny)
            )
            Imat_new, hldM_new, r_d = _woodbury_rank_ny(
                Imat_new, hldM_new, Vb, -1.0, config.jitter
            )
            retries_w = jnp.sum(r_u) + jnp.sum(r_d)
        _, logw_nn, _ = logsumexp_normalize(logw)
        ess = jnp.exp(-jax.nn.logsumexp(2.0 * logw_nn))
        xn_new, xl_new, P_new, ivec_new, Imat_new, hldp_new, logw_nn = (
            _constrain(
                xn_new, xl_new, P_new, ivec_new, Imat_new, hldp_new, logw_nn
            )
        )
        carry_new = (
            xn_new, xl_new, P_new, ivec_new, Imat_new, hldp_new, hldM_new,
            logw_nn, ivec_add, Imat_add,
            retries + retries_anc + jnp.sum(retried_kf) + retries_w,
        )
        return carry_new, (xn_new, ai.astype(jnp.int32), ess)

    Qb, dtb = _broadcast_time(Q, dt, T)
    keys = jax.random.split(key, T - 1)
    inputs = (keys, y[1:], dx, Qb, dtb, jnp.arange(1, T))
    if precomp:
        sfx_im = (
            jnp.zeros((T - 1, 0, 0), y.dtype)
            if use_wood
            else Imat_adds[1:]
        )
        inputs = inputs + (ivec_adds[1:], sfx_im)
    xn0c, xl1, P1, ivec1, Imat1, hldp1, logw1n = _constrain(
        xn0, xl1, P1, ivec1, Imat1, hldp1, logw1n
    )
    carry0 = (
        xn0c, xl1, P1, ivec1, Imat1, hldp1, hldM1, logw1n,
        ivec_add0, Imat_add0, jnp.sum(retried0) + jnp.sum(retried_w1),
    )
    final, (xn_hist, ancestors, ess_t) = jax.lax.scan(step, carry0, inputs)
    xn_f, xl_f, P_f = final[0], final[1], final[2]
    logw_f, retries = final[7], final[10]

    xn_hist_full = jnp.concatenate([xn0[None], xn_hist], axis=0)
    xn_traj = reconstruct_trajectories(xn_hist_full, ancestors)
    ak = sample_categorical(jax.random.fold_in(key, 7), jnp.exp(logw_f))
    ess0 = jnp.exp(-jax.nn.logsumexp(2.0 * logw1n))
    return (
        xn_traj[:, ak], xl_f[ak], P_f[ak].astype(jnp.float32),
        jnp.concatenate([ess0[None], ess_t]), retries,
    )


def run_rbps_information_form(
    key,
    model: DenseModel,
    dx,
    y,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPSConfig,
    mask: Optional[jnp.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    mesh=None,
) -> RBPSResult:
    """N_K information-form CPF-AS sweeps (dense features only, :77-80).

    ``mesh``: optional ``jax.sharding.Mesh`` with ``(particles, map)``
    axes — shards the sweep's ensemble over devices (multi-chip path).
    """
    if not isinstance(model, DenseModel):
        raise ValueError(
            "information-form smoother supports dense features only "
            "(as the reference, src/particleSmootherInformationForm.m:77-80); "
            "use run_rbps for sparse models"
        )
    from .rbps import _run_sweeps

    y = jnp.asarray(y)

    def sweep_fn(sub, model, dx, y, mask, x0_nonlin, x0_lin, P0_lin,
                 Q, R, dt, config, xnk, is_first):
        del mask  # dense-only: no visibility masking
        return _info_sweep(
            sub, model, dx, y, x0_nonlin, x0_lin, P0_lin,
            Q, R, dt, config, xnk, is_first, mesh,
        )

    mask_arr = jnp.ones_like(y)
    return _run_sweeps(
        sweep_fn, key, model, dx, y, mask_arr, x0_nonlin, x0_lin,
        P0_lin, Q, R, dt, config, checkpoint_dir,
    )
