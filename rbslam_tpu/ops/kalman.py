"""Batched per-particle Kalman measurement updates (dense + masked sparse).

Dense path (src/particleFilter.m:137-150,181-198): per particle i,

    S_i = C_i P_i C_i' + R          (ny x ny, ny <= 3)
    logw_i = log N(e_i; 0, S_i)
    K_i = P_i C_i' S_i^{-1}
    xl_i += K_i e_i ;  P_i -= K_i S_i K_i'

All particles at once via einsum — the [N_P, ny, nLin] x [N_P, nLin, nLin]
contractions are the batched products that dominate the cost (SURVEY
§3.1 "dominant cost").

Sparse path (src/particleFilter.m:127-136,164-180): the reference strips
NaN-masked rows to a *dynamic* size; here masked rows are kept at fixed
width and neutralized exactly — innovation zeroed, S given unit diagonal
and zero cross-terms on masked rows/cols — which leaves the Cholesky,
log-density (with n_obs = sum(mask)), gain and covariance update
numerically identical to the stripped computation while keeping static
shapes for XLA.

Functions take unbatched per-particle operands; `vmap` over particles.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..math.linalg import (
    acc_dtype,
    gaussian_logpdf_chol,
    psd_cholesky,
    solve_psd,
    symmetrize,
)


def innovation_cov(C, P, R):
    """S = C P C' + R for one particle. C: [ny, nLin], P: [nLin, nLin]."""
    CP = C @ P
    return CP @ C.T + R, CP


def dense_log_weights(C, P, xl, y, R, jitter: float):
    """Marginal innovation log-likelihood for one particle.

    Returns (logw, e, L, CP, retried).
    """
    e = y - C @ xl
    S, CP = innovation_cov(C, P, R)
    L, retried = psd_cholesky(S, jitter)
    return gaussian_logpdf_chol(e, L), e, L, CP, retried


def kalman_update_dense(C, P, xl, y, R, jitter: float, joseph: bool = False):
    """One particle's KF measurement update; returns (xl', P', logw, retried).

    ``joseph=True`` uses the Joseph-stabilized covariance update (an option
    the fp64 reference did not need; recommended under fp32, SURVEY §7.3#4).
    """
    logw, e, L, CP, retried = dense_log_weights(C, P, xl, y, R, jitter)
    # K = P C' S^{-1}  via two triangular solves on (C P)' = P C'
    K = solve_psd(L, CP).T  # [nLin, ny]
    xl_new = xl + K @ e
    if joseph:
        n = P.shape[-1]
        IKC = jnp.eye(n, dtype=P.dtype) - K @ C
        P_new = IKC @ P @ IKC.T + K @ R @ K.T
    else:
        S = CP @ C.T + R
        P_new = P - K @ S @ K.T
    return xl_new, symmetrize(P_new), logw, retried


def _mask_system(e, S, mask):
    """Neutralize masked observation rows/cols exactly.

    mask: [ny] float (1 = observed). Masked entries get e=0 and unit
    diagonal in S with zero couplings, so they contribute nothing to the
    Cholesky log-det, the whitened residual, or the gain.
    """
    m = mask
    e_m = e * m
    outer = m[:, None] * m[None, :]
    S_m = S * outer + jnp.diag(1.0 - m)
    return e_m, S_m


def masked_log_weights(yhat, H, P, y, R, mask, jitter: float):
    """Sparse/EKF innovation log-likelihood with visibility masking.

    One particle: yhat,H from the linearized model, mask from ~isnan(y)
    (src/particleFilter.m:134-136). Returns (logw, e_m, L, Hm, retried).
    """
    Hm = H * mask[:, None]
    e = jnp.nan_to_num(y) - yhat
    S = Hm @ P @ Hm.T + R * (mask[:, None] * mask[None, :])
    e_m, S_m = _mask_system(e, S, mask)
    L, retried = psd_cholesky(S_m, jitter)
    n_obs = jnp.sum(mask)
    logw = gaussian_logpdf_chol(e_m, L, n_obs=n_obs)
    return logw, e_m, L, Hm, retried


_LOG2PI = float(jnp.log(2.0 * jnp.pi))


def _chol_small_batched(S, jitter: float):
    """Closed-form batched Cholesky for ny <= 3: S [N, ny, ny].

    Pure elementwise ops over the batch instead of XLA's batched
    `cholesky`/`triangular_solve`. Where any pivot fails, the particle's
    S is shifted by a scale-aware jitter plus the Gershgorin excess
    (matching math/linalg.psd_cholesky), which makes it strictly
    diagonally dominant, so L is finite for ANY symmetric input.
    Returns (L, bad).
    """
    ny = S.shape[-1]

    def pivots(Sm):
        l11s = Sm[:, 0, 0]
        piv = [l11s]
        if ny >= 2:
            l11 = jnp.sqrt(jnp.maximum(l11s, 1e-30))
            l21 = Sm[:, 1, 0] / l11
            piv.append(Sm[:, 1, 1] - l21**2)
        if ny >= 3:
            l31 = Sm[:, 2, 0] / l11
            l22 = jnp.sqrt(jnp.maximum(piv[1], 1e-30))
            l32 = (Sm[:, 2, 1] - l31 * l21) / l22
            piv.append(Sm[:, 2, 2] - l31**2 - l32**2)
        return piv

    bad = jnp.zeros(S.shape[0], dtype=bool)
    for p in pivots(S):
        bad = bad | (p <= 0)
    eye = jnp.eye(ny, dtype=S.dtype)
    # scale-aware retry: an absolute jitter (the reference's 1e-3,
    # src/particleFilter.m:145-148) is below one ulp when S's scale is
    # large under reduced precision (bf16 eps ~ 8e-3 relative) — scale
    # by the mean diagonal so the retry actually restores PD; add the
    # Gershgorin lower bound on lambda_min for matrices too indefinite
    # for the jitter alone
    diag = jnp.diagonal(S, axis1=-2, axis2=-1)
    diag_scale = jnp.maximum(1.0, jnp.mean(diag, axis=-1))
    gmin = jnp.min(2.0 * diag - jnp.sum(jnp.abs(S), axis=-1), axis=-1)
    shift = jitter * diag_scale + jnp.maximum(0.0, -gmin)
    S = jnp.where(bad[:, None, None], S + shift[:, None, None] * eye, S)

    L = jnp.zeros_like(S)
    l11 = jnp.sqrt(S[:, 0, 0])
    L = L.at[:, 0, 0].set(l11)
    if ny >= 2:
        l21 = S[:, 1, 0] / l11
        l22 = jnp.sqrt(S[:, 1, 1] - l21**2)
        L = L.at[:, 1, 0].set(l21).at[:, 1, 1].set(l22)
    if ny >= 3:
        l31 = S[:, 2, 0] / l11
        l32 = (S[:, 2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(S[:, 2, 2] - l31**2 - l32**2)
        L = L.at[:, 2, 0].set(l31).at[:, 2, 1].set(l32).at[:, 2, 2].set(l33)
    return L, bad


def _tri_solve_small_batched(L, b):
    """Forward-substitute L v = b, batched, ny <= 3 (elementwise)."""
    ny = L.shape[-1]
    v0 = b[:, 0] / L[:, 0, 0]
    vs = [v0]
    if ny >= 2:
        vs.append((b[:, 1] - L[:, 1, 0] * v0) / L[:, 1, 1])
    if ny >= 3:
        vs.append(
            (b[:, 2] - L[:, 2, 0] * vs[0] - L[:, 2, 1] * vs[1])
            / L[:, 2, 2]
        )
    return jnp.stack(vs, axis=-1)


def _Li_from_chol_small_batched(L):
    """L^-1 (lower), batched, ny <= 3 (elementwise)."""
    ny = L.shape[-1]
    Li = jnp.zeros_like(L)
    Li = Li.at[:, 0, 0].set(1.0 / L[:, 0, 0])
    if ny >= 2:
        Li = Li.at[:, 1, 1].set(1.0 / L[:, 1, 1])
        Li = Li.at[:, 1, 0].set(-L[:, 1, 0] * Li[:, 0, 0] / L[:, 1, 1])
    if ny >= 3:
        Li = Li.at[:, 2, 2].set(1.0 / L[:, 2, 2])
        Li = Li.at[:, 2, 1].set(-L[:, 2, 1] * Li[:, 1, 1] / L[:, 2, 2])
        Li = Li.at[:, 2, 0].set(
            -(L[:, 2, 0] * Li[:, 0, 0] + L[:, 2, 1] * Li[:, 1, 0])
            / L[:, 2, 2]
        )
    return Li


def _inv_from_chol_small_batched(L):
    """S^-1 = L^-T L^-1, batched, ny <= 3 (elementwise)."""
    Li = _Li_from_chol_small_batched(L)
    return jnp.einsum("pki,pkj->pij", Li, Li)


def kalman_update_dense_batched(C, P, xl, y, R, jitter: float,
                                joseph: bool = False,
                                symmetrize_out: bool = True):
    """Whole-ensemble dense KF update: C [N,ny,nl], P [N,nl,nl], xl [N,nl].

    Same math as :func:`kalman_update_dense`; for ny <= 3 the innovation
    factorization/solves use closed-form elementwise algebra over the
    batch (see :func:`_chol_small_batched`) instead of lax.linalg.
    Returns (xl', P', logw [N], retried [N]).
    """
    return kalman_update_dense_batched_hld(
        C, P, xl, y, R, jitter, joseph, symmetrize_out
    )[:4]


def kalman_update_dense_batched_hld(C, P, xl, y, R, jitter: float,
                                    joseph: bool = False,
                                    symmetrize_out: bool = True):
    """As :func:`kalman_update_dense_batched` but additionally returns
    ``hld_S [N] = sum log diag chol(S)`` — the innovation half-log-det the
    information-form smoother's ``halfLogDetP`` recursion consumes
    (src/particleSmootherInformationForm.m:298).

    ``symmetrize_out=False`` skips the trailing covariance symmetrization
    — a full extra HBM pass over P. The reference filter does not
    symmetrize either (``P -= K*SS*K'``, src/particleFilter.m:198); the
    K S K' downdate is symmetric up to fp rounding and the jitter-retry
    counter surfaces any drift.
    """
    if C.shape[1] <= 3:
        return _kalman_update_dense_batched_small(
            C, P, xl, y, R, jitter, joseph, symmetrize_out
        )
    return _kalman_update_dense_batched_lax(
        C, P, xl, y, R, jitter, joseph, symmetrize_out
    )


def _kalman_update_dense_batched_small(C, P, xl, y, R, jitter, joseph,
                                        symmetrize_out=True):
    cdtype = C.dtype
    e = y[None, :] - jnp.einsum("pij,pj->pi", C, xl)
    # contract P's LAST axis (exact for the symmetric covariance; equal
    # by symmetry of S/K/downdate either way): the 'pij,pjk' form made
    # XLA assign P a transposed {1,2,0} layout while the downdate
    # producer emits {2,1,0} — a full [N, nl, nl] layout-copy pass per
    # step in the info-form smoother trace (scripts/trace_smoother.py)
    acc = acc_dtype(C, P)
    CP = jnp.einsum("pij,pkj->pik", C, P, preferred_element_type=acc)
    S = jnp.einsum("pik,pjk->pij", CP, C, preferred_element_type=acc) + R
    L, retried = _chol_small_batched(S, jitter)
    v = _tri_solve_small_batched(L, e)
    ny = e.shape[-1]
    hld = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    logw = -hld - 0.5 * jnp.sum(v * v, axis=-1) - 0.5 * ny * _LOG2PI
    Sinv = _inv_from_chol_small_batched(L)
    K = jnp.einsum("pji,pjk->pik", CP, Sinv)            # [N, nl, ny]
    xl_new = xl + jnp.einsum("pij,pj->pi", K, e)
    if joseph:
        n = P.shape[-1]
        IKC = jnp.eye(n, dtype=cdtype) - K @ C
        P_new = jnp.einsum(
            "pij,pjk,plk->pil", IKC, P.astype(cdtype), IKC,
            preferred_element_type=acc,
        ) + K @ R @ jnp.swapaxes(K, -1, -2)
    else:
        # P - K S K' == P - (CP)' Sinv (CP); the downdate is computed in
        # f32 and subtracted in the storage dtype so no P-sized f32
        # temporary is materialized (bf16 carry at large N). The rank-ny
        # outer product is a SUM OF BROADCASTS, not a thin-K einsum —
        # XLA lowers the K=ny matmul as a convolution whose [N, nl, nl]
        # output takes a transposed layout and costs a full layout-copy
        # pass per step (scripts/trace_smoother.py)
        X = jnp.einsum("pij,pjk->pik", Sinv, CP, preferred_element_type=acc)
        CPf = CP.astype(acc)
        downdate = sum(
            CPf[:, j][:, :, None] * X[:, j][:, None, :]
            for j in range(e.shape[-1])
        )
        P_new = P - downdate.astype(P.dtype)
    if symmetrize_out:
        P_new = symmetrize(P_new)
    return xl_new, P_new.astype(P.dtype), logw, retried, hld


def _kalman_update_dense_batched_lax(C, P, xl, y, R, jitter, joseph,
                                     symmetrize_out=True):
    # P may arrive in a reduced-precision storage dtype (bf16 covariance
    # carry); all contractions accumulate in at least f32
    cdtype = C.dtype
    e = y[None, :] - jnp.einsum("pij,pj->pi", C, xl)
    acc = acc_dtype(C, P)
    CP = jnp.einsum("pij,pjk->pik", C, P, preferred_element_type=acc)
    S = jnp.einsum("pik,pjk->pij", CP, C, preferred_element_type=acc) + R
    L, retried = psd_cholesky(S, jitter)
    logw = gaussian_logpdf_chol(e, L)
    hld = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    K = jnp.swapaxes(solve_psd(L, CP), -1, -2)          # [N, nl, ny]
    xl_new = xl + jnp.einsum("pij,pj->pi", K, e)
    if joseph:
        n = P.shape[-1]
        IKC = jnp.eye(n, dtype=cdtype) - K @ C
        P_new = jnp.einsum(
            "pij,pjk,plk->pil", IKC, P.astype(cdtype), IKC,
            preferred_element_type=acc,
        ) + K @ R @ jnp.swapaxes(K, -1, -2)
    else:
        downdate = jnp.einsum(
            "pij,pjk,plk->pil", K, S, K,
            preferred_element_type=acc,
        )
        P_new = P - downdate.astype(P.dtype)
    if symmetrize_out:
        P_new = symmetrize(P_new)
    return xl_new, P_new.astype(P.dtype), logw, retried, hld


def kalman_update_masked_batched(yhat, H, P, xl, y, R, mask, jitter: float):
    """Whole-ensemble masked (sparse/EKF) update; see
    :func:`kalman_update_masked`. yhat [N,ny], H [N,ny,nl]."""
    m = mask
    Hm = H * m[None, :, None]
    e = (jnp.nan_to_num(y)[None, :] - yhat) * m[None, :]
    R_m = R * (m[:, None] * m[None, :])
    PHt = P @ jnp.swapaxes(Hm, -1, -2)                  # [N, nl, ny]
    S = jnp.einsum("pij,pjk->pik", Hm, PHt) + R_m + jnp.diag(1.0 - m)
    L, retried = psd_cholesky(S, jitter)
    n_obs = jnp.sum(m)
    logw = gaussian_logpdf_chol(e, L, n_obs=n_obs)
    K = jnp.swapaxes(solve_psd(L, jnp.swapaxes(PHt, -1, -2)), -1, -2)
    xl_new = xl + jnp.einsum("pij,pj->pi", K, e)
    P_new = P - K @ S @ jnp.swapaxes(K, -1, -2)
    return xl_new, symmetrize(P_new), logw, retried


def kalman_update_masked(yhat, H, P, xl, y, R, mask, jitter: float):
    """Sparse/EKF masked measurement update; returns (xl', P', logw, retried)."""
    logw, e_m, L, Hm, retried = masked_log_weights(
        yhat, H, P, y, R, mask, jitter
    )
    PHt = P @ Hm.T                     # [nLin, ny]; masked cols are zero
    K = solve_psd(L, PHt.T).T          # block structure keeps them zero
    xl_new = xl + K @ e_m
    S_m = Hm @ PHt + R * (mask[:, None] * mask[None, :]) + jnp.diag(1.0 - mask)
    P_new = P - K @ S_m @ K.T
    return xl_new, symmetrize(P_new), logw, retried
