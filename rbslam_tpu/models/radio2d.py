"""Dense radio-SLAM model: planar position + heading, scalar RSS field.

Reference semantics (examples/slam-dense-radio/run_dense2D_withHeading.m):

- state xn = [p1, p2, theta];
- dynamics rotate the odometry increment into the heading frame and add
  noise ONLY on heading (:75-77):
      p'     = p + R(theta)^T u[:2]
      theta' = theta + u[2] + chol(dt*Q) * xi
  (Q is the 1x1 heading process noise, time-varying with spikes);
- dynamics residual is the whitened heading residual (:77);
- measurement Jacobian is the eigenbasis row at the position (:168):
      C(xn) = phi(p) [1, m],  y = C xl + r.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..basis.laplace import LaplaceBasis
from .base import DenseModel


def _heading_rot_T(theta):
    """R(theta)^T with R = [[c, -s], [s, c]] (run_dense2D_withHeading.m:75)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.array([[c, s], [-s, c]])


def make_radio2d_model(
    basis: LaplaceBasis,
    center=None,
) -> DenseModel:
    m = basis.m
    c = jnp.zeros(2) if center is None else jnp.asarray(center)

    def dynamics(key, xn, u, dt, Q):
        p, theta = xn[:2], xn[2]
        xi = jax.random.normal(key, (), dtype=xn.dtype)
        sigma = jnp.sqrt(dt * Q[0, 0])
        p_new = p + _heading_rot_T(theta) @ u[:2]
        return jnp.concatenate(
            [p_new, (theta + u[2] + sigma * xi)[None]]
        )

    def dyn_residual(xn_ref, xn, u, dt, Q):
        sigma = jnp.sqrt(dt * Q[0, 0])
        return ((xn_ref[2] - xn[2] - u[2]) / sigma)[None]

    def meas_jacobian(xn):
        return basis.phi(xn[:2] - c)[None, :]  # [1, m]

    return DenseModel(
        dynamics=dynamics,
        dyn_residual=dyn_residual,
        meas_jacobian=meas_jacobian,
        n_nonlin=3,
        n_lin=m,
        ny=1,
    )
