"""PSD-safe Cholesky, Gaussian log-densities, log-weight utilities.

The reference retries a failed `chol` once with a fixed diagonal jitter
(src/particleFilter.m:145-148 with 1e-3, src/particleSmoother.m:70 with
1e-2). Under XLA a failed Cholesky returns NaNs rather than raising, so
:func:`psd_cholesky` reproduces the retry branch-free: factor once, detect
non-finite columns, refactor with jitter, select — and reports how many
retries fired so callers can surface it as a numerics metric (SURVEY §5
"race detection / sanitizers" plan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LOG2PI = float(jnp.log(2.0 * jnp.pi))


def acc_dtype(*arrays):
    """Accumulation dtype of a contraction over ``arrays``: float32 for
    bf16 or f32 storage, float64 when an operand is float64 (a GEMM with
    f64 operands and an f32 result does not lower on the GPU)."""
    return jnp.promote_types(jnp.result_type(*arrays), jnp.float32)


def symmetrize(A):
    """0.5*(A + A^T) over the trailing two axes (as ekf_dense.m:92)."""
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def psd_cholesky(A, jitter: float):
    """Lower Cholesky with a fixed-jitter retry + guaranteed PSD repair.

    Returns ``(L, retried)`` where ``retried`` is a boolean (per batch
    element) that is True when a repaired factorization was used. Stage 1
    is the branch-free equivalent of the reference's ``chol`` flag retry
    (src/particleFilter.m:145-148: one fixed-jitter refactorization);
    stage 2 — for matrices too indefinite for the fixed jitter — shifts
    by the Gershgorin lower bound on the smallest eigenvalue, which makes
    the factorization finite for ANY symmetric input (the diagonal then
    dominates each row), so callers never propagate NaN into weights.
    """
    L = jnp.linalg.cholesky(A)
    bad = ~jnp.all(jnp.isfinite(L), axis=(-2, -1))
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)

    def refactor(_):
        L_j = jnp.linalg.cholesky(A + jitter * eye)
        still_bad = ~jnp.all(jnp.isfinite(L_j), axis=(-2, -1))

        def gershgorin(_):
            # lambda_min >= min_i (A_ii - sum_{j != i} |A_ij|)
            diag = jnp.diagonal(A, axis1=-2, axis2=-1)
            offsum = jnp.sum(jnp.abs(A), axis=-1) - jnp.abs(diag)
            gmin = jnp.min(diag - offsum, axis=-1)
            shift = jitter + jnp.maximum(0.0, -gmin)
            L_g = jnp.linalg.cholesky(
                A + shift[..., None, None] * eye
            )
            return jnp.where(still_bad[..., None, None], L_g, L_j)

        L_j = jax.lax.cond(
            jnp.any(still_bad), gershgorin, lambda _: L_j, None
        )
        return jnp.where(bad[..., None, None], L_j, L)

    # the retry is rare: guard the extra factorizations behind a cond so
    # the common path costs a single Cholesky
    L = jax.lax.cond(jnp.any(bad), refactor, lambda _: L, None)
    return L, bad


def tril_solve(L, b):
    """Solve L x = b for lower-triangular L; b is [..., n] or [..., n, k]."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    x = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return x[..., 0] if vec else x


def solve_psd(L, b):
    """Solve A x = b given the lower Cholesky L of A (two triangular solves)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
    return x[..., 0] if vec else x


def half_logdet(L):
    """0.5*log|A| = sum(log diag L) for A = L L^T."""
    return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def gaussian_logpdf_chol(e, L, n_obs=None):
    """log N(e; 0, S) given lower Cholesky L of S.

    Matches the reference log-weight formula
    ``-sum(log diag cS) - .5*v'v - .5*numel(e)*log(2*pi)``
    (src/particleFilter.m:149-150). ``n_obs`` overrides the dimension
    count for masked (padded) observations.
    """
    v = tril_solve(L, e)
    if n_obs is None:
        n_obs = e.shape[-1]
    return (
        -half_logdet(L)
        - 0.5 * jnp.sum(v * v, axis=-1)
        - 0.5 * n_obs * _LOG2PI
    )


def logsumexp_normalize(logw):
    """Log-sum-exp normalize (src/particleFilter.m:153-156).

    Returns ``(w, logw_normalized, logZ)``.
    """
    logZ = jax.nn.logsumexp(logw, axis=-1, keepdims=True)
    logw_n = logw - logZ
    return jnp.exp(logw_n), logw_n, logZ[..., 0]


def ess_from_logw(logw):
    """Effective sample size from (unnormalized) log weights."""
    _, logw_n, _ = logsumexp_normalize(logw)
    return jnp.exp(-jax.nn.logsumexp(2.0 * logw_n, axis=-1))
