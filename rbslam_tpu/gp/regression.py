"""Batch reduced-rank GP regression with ML-II hyperparameter fitting.

The offline "training" path of the framework (SURVEY §3.5): the
scalar-potential magnetic map builder used by the mag-localization
workload. Reference: tools/gp_scalar_potential_fast.m —

- gradient-observation design matrix Phi = [dPhi_x; dPhi_y; dPhi_z] with
  linear-kernel columns prepended (:98-106),
- reduced-rank negative log marginal likelihood (:242-247):
      NLL = 1/2 (y'y - v'v)/sigma2
          + 1/2 [(n-m) log sigma2 + sum log k + 2 sum log diag L]
          + n/2 log 2pi,    L = chol(Phi'Phi + diag(sigma2/k))
- posterior solve through the same Cholesky (:190-207).

Differences: the NLL is one jitted function of the
log-hyperparameters and the gradient comes from autodiff (the reference
hand-derives it, :257-290); the optimizer is scipy L-BFGS on host (this
is offline fitting, matching `fminunc` usage :148-170), with the m^3
Cholesky running on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.laplace import domain_center, hypercube_basis
from ..basis.potential import ScalarPotentialBasis
from ..basis.spectral import linear_plus_se_spectral

_LOG2PI = float(np.log(2.0 * np.pi))


@dataclass
class ReducedRankGP:
    """Fitted map: posterior over [linear(3); basis(m)] weights."""

    potential: ScalarPotentialBasis
    center: np.ndarray            # domain center (shift inputs by this)
    theta: np.ndarray             # [linSigma2, lengthScale, magnSigma2, sigma2]
    mean_weights: jnp.ndarray     # [n_lin] posterior mean ("foo", :190-207)
    chol: jnp.ndarray             # [n_lin, n_lin] lower chol of Phi'Phi + diag(sigma2/k)
    nll: float

    def _row_variance(self, rows):
        """sigma2 * diag(rows A^-1 rows') for rows [..., n_lin]."""
        shape = rows.shape
        flat = rows.reshape(-1, shape[-1])
        V = jax.scipy.linalg.solve_triangular(self.chol, flat.T, lower=True)
        return (self.theta[3] * jnp.sum(V * V, axis=0)).reshape(shape[:-1])

    def predict_gradient(self, x):
        """Posterior mean and per-axis variance of grad f at x [.., 3]."""
        xc = jnp.asarray(x) - jnp.asarray(self.center, jnp.asarray(x).dtype)
        C = self.potential.grad_blocks(xc)
        mean = C @ self.mean_weights
        return mean, self._row_variance(C)

    def predict_potential(self, x):
        xc = jnp.asarray(x) - jnp.asarray(self.center, jnp.asarray(x).dtype)
        row = self.potential.potential_row(xc)
        mean = row @ self.mean_weights
        return mean, self._row_variance(row)


@partial(jax.jit, static_argnames=("n_obs",))
def scalar_potential_nll(log_theta, sqrt_lambda, PhiPhi, Phiy, yy, n_obs: int):
    """Reduced-rank NLL as a function of log hyperparameters (:242-247)."""
    lin_s2, ell, magn_s2, sigma2 = jnp.exp(log_theta)
    k = linear_plus_se_spectral(sqrt_lambda, lin_s2, ell, magn_s2, 3)
    m = Phiy.shape[0]
    A = PhiPhi + jnp.diag(sigma2 / k)
    L = jnp.linalg.cholesky(A)
    v = jax.scipy.linalg.solve_triangular(L, Phiy, lower=True)
    yiQy = (yy - v @ v) / sigma2
    logdetQ = (
        (n_obs - m) * jnp.log(sigma2)
        + jnp.sum(jnp.log(k))
        + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    )
    return 0.5 * yiQy + 0.5 * logdetQ + 0.5 * n_obs * _LOG2PI


def fit_scalar_potential_gp(
    x,
    y,
    m: int,
    LL,
    theta0,
    optimize: bool = True,
    maxiter: int = 100,
) -> ReducedRankGP:
    """Fit the curl-free magnetic map.

    x: [n, 3] positions; y: [n, 3] field observations;
    theta0: initial [linSigma2, lengthScale, magnSigma2, sigma2].
    """
    LL = np.asarray(LL, dtype=np.float64)
    center = domain_center(LL)
    potential = ScalarPotentialBasis(hypercube_basis(m, LL))
    xc = jnp.asarray(x, jnp.float32) - jnp.asarray(center, jnp.float32)

    # design matrix: stack the three gradient components (:138-140)
    C = potential.grad_blocks(xc)                 # [n, 3, n_lin]
    Phi = jnp.concatenate([C[:, 0], C[:, 1], C[:, 2]], axis=0)
    yvec = jnp.concatenate(
        [jnp.asarray(y)[:, 0], jnp.asarray(y)[:, 1], jnp.asarray(y)[:, 2]]
    )
    PhiPhi = Phi.T @ Phi
    Phiy = Phi.T @ yvec
    yy = yvec @ yvec
    n_obs = int(yvec.shape[0])
    sqrt_lambda = jnp.asarray(
        np.sqrt(potential.basis.eigenvalues), jnp.float32
    )

    theta = np.asarray(theta0, dtype=np.float64)
    if optimize:
        from scipy.optimize import minimize

        val_grad = jax.jit(
            jax.value_and_grad(
                lambda lt: scalar_potential_nll(
                    lt, sqrt_lambda, PhiPhi, Phiy, yy, n_obs
                )
            )
        )

        def fun(w):
            v, g = val_grad(jnp.asarray(w, jnp.float32))
            return float(v), np.asarray(g, np.float64)

        out = minimize(
            fun,
            np.log(theta),
            jac=True,
            method="L-BFGS-B",
            options={"maxiter": maxiter},
        )
        theta = np.exp(out.x)

    lin_s2, ell, magn_s2, sigma2 = theta
    k = linear_plus_se_spectral(
        sqrt_lambda, jnp.asarray(lin_s2), jnp.asarray(ell),
        jnp.asarray(magn_s2), 3,
    )
    A = PhiPhi + jnp.diag(jnp.asarray(sigma2, jnp.float32) / k)
    L = jnp.linalg.cholesky(A)
    v = jax.scipy.linalg.solve_triangular(L, Phiy, lower=True)
    mean_w = jax.scipy.linalg.solve_triangular(L.T, v, lower=False)
    nll = float(
        scalar_potential_nll(
            jnp.asarray(np.log(theta), jnp.float32),
            sqrt_lambda, PhiPhi, Phiy, yy, n_obs,
        )
    )
    return ReducedRankGP(
        potential=potential,
        center=center,
        theta=theta,
        mean_weights=mean_w,
        chol=L,
        nll=nll,
    )
