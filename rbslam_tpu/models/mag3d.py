"""Dense 3D magnetic-field SLAM model: position + quaternion, curl-free map.

Reference semantics (examples/slam-dense-mag/run_dense3D_magfield.m):

- state xn = [p (3), q (4)] with scalar-first unit quaternion;
- dynamics (:301-308):
      p' = p + u[:3] + chol(dt*Q_pos) xi_p
      dq = u_q ⊗ expq(chol(dt*Q_ori) xi_q)        (noisy increment)
      q' = q ⊗ dq
- dynamics residual for ancestor sampling (:202-203):
      e = [p_ref - p - u[:3] ; logq(dq_u^{-1} ⊗ q^{-1} ⊗ q_ref)]
      whitened by the Cholesky of dt*Q (block diagonal).
  (The reference right-divides the row vector by chol(dt*Q); for the
  diagonal Q used throughout this equals the true whitening L^{-1} e
  implemented here.)
- measurement Jacobian (:265-279): body-frame field,
      C(xn) = R(q)^T @ [I_3 | grad phi(p)]   -> [3, 3 + m]
  so y = C xl + r with xl = [linear weights (3); basis weights (m)].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..basis.potential import ScalarPotentialBasis
from ..math.quaternions import expq, logq, qinv, qmul, quat_to_rmat
from .base import DenseModel

_IPOS = slice(0, 3)
_IQUAT = slice(3, 7)


def dynamics_with_increment(key, xn, u, dt, Q):
    """Returns (xn', dq) — dq is the noisy quaternion increment used by the
    odometry generator (run_dense3D_magfield.m:301-308 second output)."""
    kp, kq = jax.random.split(key)
    p, q = xn[_IPOS], xn[_IQUAT]
    Lp = jnp.linalg.cholesky(dt * Q[:3, :3])
    Lq = jnp.linalg.cholesky(dt * Q[3:6, 3:6])
    p_new = p + u[:3] + Lp @ jax.random.normal(kp, (3,), dtype=xn.dtype)
    dq = qmul(u[3:7], expq(Lq @ jax.random.normal(kq, (3,), dtype=xn.dtype)))
    q_new = qmul(q, dq)
    return jnp.concatenate([p_new, q_new]), dq


def make_mag3d_model(
    potential: ScalarPotentialBasis,
    center=None,
) -> DenseModel:
    """Build the dense magnetic model.

    ``center`` shifts positions into the basis' centered domain.
    """
    n_lin = potential.n_lin
    c = jnp.zeros(3) if center is None else jnp.asarray(center)

    def dynamics_batch(key, xn, u, dt, Q):
        """Whole-ensemble transition: one [P, 6] noise draw (same
        distribution as vmapped `dynamics`, cheaper key derivation) and
        closed-form 3x3 Cholesky (a tiny factorization needs no
        lax.linalg call)."""
        from ..ops.kalman import _chol_small_batched

        n = xn.shape[0]
        Lp = _chol_small_batched(dt * Q[None, :3, :3], 0.0)[0][0]
        Lq = _chol_small_batched(dt * Q[None, 3:6, 3:6], 0.0)[0][0]
        w = jax.random.normal(key, (n, 6), dtype=xn.dtype)
        p_new = xn[:, _IPOS] + u[:3][None, :] + w[:, :3] @ Lp.T
        dq = qmul(u[3:7][None, :], expq(w[:, 3:] @ Lq.T))
        q_new = qmul(xn[:, _IQUAT], dq)
        return jnp.concatenate([p_new, q_new], axis=-1)

    def dynamics(key, xn, u, dt, Q):
        xn_new, _ = dynamics_with_increment(key, xn, u, dt, Q)
        return xn_new

    def dyn_residual(xn_ref, xn, u, dt, Q):
        e_pos = xn_ref[_IPOS] - xn[_IPOS] - u[:3]
        q_err = qmul(qmul(qinv(u[3:7]), qinv(xn[_IQUAT])), xn_ref[_IQUAT])
        e_ori = logq(q_err)
        e = jnp.concatenate([e_pos, e_ori])
        L = jnp.linalg.cholesky(dt * Q)
        return jax.scipy.linalg.solve_triangular(L, e, lower=True)

    def meas_jacobian(xn):
        C_nav = potential.grad_blocks(xn[_IPOS] - c)      # [3, 3+m]
        Rnb = quat_to_rmat(xn[_IQUAT])                    # [3, 3]
        return Rnb.T @ C_nav

    return DenseModel(
        dynamics=dynamics,
        dyn_residual=dyn_residual,
        meas_jacobian=meas_jacobian,
        n_nonlin=7,
        n_lin=n_lin,
        ny=3,
        dynamics_batch=dynamics_batch,
    )
