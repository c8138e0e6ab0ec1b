"""Dense EKF baseline with error-state orientation relinearization.

Reference: examples/slam-dense-mag/ekf_dense.m (after Viset, Helmons &
Kok 2022). State: [position(3), orientation error(3), map(n_lin)] plus a
quaternion linearization point q_nb. Per step: propagate mean and
covariance through the odometry (:70-75), Kalman-update with the full
Jacobian — position block from the field Hessian, orientation block from
the skew of the predicted field, map block from the basis gradients
(run_dense3D_magfield.m:281-299) — then fold the orientation error back
into q_nb (:95-96).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.potential import ScalarPotentialBasis
from ..math.linalg import psd_cholesky, solve_psd, symmetrize
from ..math.quaternions import expq, mcross, qmul, quat_to_rmat


class EKFResult(NamedTuple):
    x_traj: jnp.ndarray      # [T, 6 + n_lin] filtered means (ori error == 0)
    q_traj: jnp.ndarray      # [T, 4] linearization quaternions
    P_final: jnp.ndarray     # [n, n] final covariance
    chol_retries: jnp.ndarray


# Bounded LRU keyed on the basis's defining parameters (not object
# identity): Monte-Carlo loops that rebuild an identical basis per run
# hit the same entry, and eviction releases the pinned jitted closure +
# executable instead of leaking them for the process lifetime.
_JIT_CACHE: "OrderedDict" = OrderedDict()
_JIT_CACHE_MAX = 8


def _basis_cache_key(potential: ScalarPotentialBasis) -> tuple:
    b = potential.basis
    return (
        int(b.m),
        np.asarray(b.L).tobytes(),
        np.asarray(b.NN).tobytes(),
    )


def run_ekf_dense(
    potential: ScalarPotentialBasis,
    dx,
    y,
    x0,          # [6 + n_lin]
    q0,          # [4]
    P0,          # [n, n]
    Q,           # process noise [6, 6] or [T-1, 6, 6]
    R,           # [3, 3]
    dt,
    jitter: float = 1e-3,
):
    # jit the whole filter (memoized per basis parameters) so the scan
    # compiles once and hits the persistent compilation cache — an
    # un-jitted lax.scan recompiles per call and bypasses the disk cache
    ck = (_basis_cache_key(potential), float(jitter))
    if ck not in _JIT_CACHE:
        _JIT_CACHE[ck] = jax.jit(
            lambda *a: _run_ekf_dense(potential, *a, jitter=jitter)
        )
        while len(_JIT_CACHE) > _JIT_CACHE_MAX:
            _JIT_CACHE.popitem(last=False)
    else:
        _JIT_CACHE.move_to_end(ck)
    return _JIT_CACHE[ck](dx, y, x0, q0, P0, Q, R, dt)


def run_ekf_dense_batched(
    potential: ScalarPotentialBasis,
    dx,          # [B, T-1, n_u]
    y,           # [B, T, 3]
    x0,          # [6 + n_lin] (shared) or [B, 6 + n_lin]
    q0,          # [4] or [B, 4]
    P0,          # [n, n] shared initial covariance
    Q,
    R,
    dt,
    jitter: float = 1e-3,
):
    """Batched EKF: one vmapped scan over B Monte-Carlo runs.

    The sequential EKF wastes the chip on [n, n] x [3, n] products (n =
    6 + n_lin, up to 521); batching the MC repetitions of the reference's
    disturbance sweep (examples/slam-dense-mag/main.m:37-60) turns every
    per-step product into a [B, n, n] batched matmul — the whole nSim=20
    sweep costs about one sequential run. Returns EKFResult with a
    leading batch axis on every field.
    """
    ck = (_basis_cache_key(potential), float(jitter), "batched",
          int(dx.shape[0]), x0.ndim, jnp.asarray(q0).ndim)
    if ck not in _JIT_CACHE:
        in_axes = (0, 0, 0 if jnp.asarray(x0).ndim == 2 else None,
                   0 if jnp.asarray(q0).ndim == 2 else None,
                   None, None, None, None)
        _JIT_CACHE[ck] = jax.jit(
            jax.vmap(
                lambda *a: _run_ekf_dense(potential, *a, jitter=jitter),
                in_axes=in_axes,
            )
        )
        while len(_JIT_CACHE) > _JIT_CACHE_MAX:
            _JIT_CACHE.popitem(last=False)
    else:
        _JIT_CACHE.move_to_end(ck)
    return _JIT_CACHE[ck](dx, y, x0, q0, P0, Q, R, dt)


def _run_ekf_dense(
    potential: ScalarPotentialBasis,
    dx,
    y,
    x0,
    q0,
    P0,
    Q,
    R,
    dt,
    jitter: float = 1e-3,
):
    T = y.shape[0]
    n = x0.shape[0]
    Q = jnp.asarray(Q)
    if Q.ndim == 2:
        Q = jnp.broadcast_to(Q, (T - 1,) + Q.shape)
    dt = jnp.asarray(dt)
    if dt.ndim == 0:
        dt = jnp.broadcast_to(dt, (T - 1,))

    def measure(x, q):
        """(yhat, H [3, n]) at the current linearization point
        (run_dense3D_magfield.m:281-299)."""
        pos = x[:3]
        xl = x[6:]
        C_nav = potential.grad_blocks(pos)              # [3, n_lin]
        Rnb = quat_to_rmat(q)
        field_nav = C_nav @ xl
        yhat = Rnb.T @ field_nav
        Hpos = Rnb.T @ jnp.einsum("ijk,k->ij", potential.hess_blocks(pos), xl)
        Hori = Rnb.T @ mcross(field_nav)
        Hmap = Rnb.T @ C_nav
        return yhat, jnp.concatenate([Hpos, Hori, Hmap], axis=-1)

    def update(x, q, P, y_t):
        yhat, H = measure(x, q)
        e = y_t - yhat
        S = H @ P @ H.T + R
        L, retried = psd_cholesky(S, jitter)
        K = solve_psd(L, H @ P).T
        x_new = x + K @ e
        P_new = symmetrize(P - K @ S @ K.T)
        # relinearize orientation (ekf_dense.m:95-96)
        q_new = qmul(expq(x_new[3:6] / 2.0), q)
        x_new = x_new.at[3:6].set(0.0)
        return x_new, q_new, P_new, retried

    x1, q1, P1, r0 = update(jnp.asarray(x0), jnp.asarray(q0), jnp.asarray(P0), y[0])

    def step(carry, inputs):
        x, q, P, retries = carry
        y_t, u, Q_t, dt_t = inputs
        # dynamics (run_dense3D_magfield.m:310-316): position += dPos,
        # orientation linearization point composes the increment,
        # F = I, G injects Q into the pose blocks
        x_pred = x.at[:3].add(u[:3])
        q_pred = qmul(q, u[3:7])
        G_rot = quat_to_rmat(q_pred)
        Qt = dt_t * Q_t
        Qpose = jnp.zeros((n, n), dtype=P.dtype)
        Qpose = Qpose.at[:3, :3].set(Qt[:3, :3])
        Qpose = Qpose.at[3:6, 3:6].set(G_rot @ Qt[3:6, 3:6] @ G_rot.T)
        P_pred = P + Qpose
        x_new, q_new, P_new, retried = update(x_pred, q_pred, P_pred, y_t)
        return (x_new, q_new, P_new, retries + retried), (x_new, q_new)

    (xf, qf, Pf, retries), (xs, qs) = jax.lax.scan(
        step, (x1, q1, P1, r0.astype(jnp.int32)), (y[1:], dx, Q, dt)
    )
    x_traj = jnp.concatenate([x1[None], xs], axis=0)
    q_traj = jnp.concatenate([q1[None], qs], axis=0)
    return EKFResult(
        x_traj=x_traj, q_traj=q_traj, P_final=Pf, chol_retries=retries
    )
