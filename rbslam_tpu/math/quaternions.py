"""Batched quaternion / rotation algebra, vmap-native.

Semantics match the reference MATLAB toolbox (tools/expq.m, tools/logq.m,
tools/qLeft.m, tools/qRight.m, tools/qInv.m, tools/quat2rmat.m,
tools/rmat2quat.m, tools/quat2euler.m, tools/mcross.m) but every function
here is written for the *single* element with trailing-axis quaternions
``[..., 4]`` and broadcasts/vmaps naturally — the MATLAB batched variants
(4x4xN multiplication-matrix stacks built through ``multiprod``) are
unnecessary where `vmap`+`einsum` produce the same batched matmuls
directly.

Conventions: scalar-first unit quaternions ``q = [w, x, y, z]``; canonical
sign has nonnegative scalar part (reference expq.m:22-38).
"""

from __future__ import annotations

import jax.numpy as jnp


def mcross(v):
    """Skew-symmetric cross-product matrix ``[v x]`` (tools/mcross.m:33-42).

    v: [..., 3] -> [..., 3, 3] with (M @ w) == cross(v, w).
    """
    v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2]
    z = jnp.zeros_like(v1)
    return jnp.stack(
        [
            jnp.stack([z, -v3, v2], axis=-1),
            jnp.stack([v3, z, -v1], axis=-1),
            jnp.stack([-v2, v1, z], axis=-1),
        ],
        axis=-2,
    )


def expq(phi):
    """Quaternion exponential R^3 -> S^3, canonical sign (tools/expq.m).

    phi: [..., 3] rotation vector (half-angle convention: ``expq(phi)``
    rotates by ``2*|phi|``, matching the reference where callers pass
    ``phi/2``). Returns [..., 4].
    """
    mag = jnp.linalg.norm(phi, axis=-1, keepdims=True)
    # sinc-style safe normalization: sin(m)/m -> 1 as m -> 0
    sinc = jnp.where(mag > 0, jnp.sin(mag) / jnp.where(mag > 0, mag, 1.0), 1.0)
    q = jnp.concatenate([jnp.cos(mag), phi * sinc], axis=-1)
    # canonical sign: scalar part >= 0
    return jnp.where(q[..., :1] < 0, -q, q)


def logq(q):
    """Quaternion logarithm S^3 -> R^3 (tools/logq.m).

    q: [..., 4] -> [..., 3]; inverse of :func:`expq` on the canonical
    hemisphere.
    """
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    na = jnp.arccos(w)
    s = jnp.sin(na)
    scale = jnp.where(na > 0, na / jnp.where(s > 0, s, 1.0), 1.0)
    return q[..., 1:] * scale


def qmul(q1, q2):
    """Hamilton product q1 ⊗ q2, broadcasting over leading axes."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - jnp.sum(v1 * v2, axis=-1, keepdims=True)
    v = w1 * v2 + w2 * v1 + jnp.cross(v1, v2)
    return jnp.concatenate([w, v], axis=-1)


def qleft(q):
    """Left multiplication matrix: qleft(q) @ p == qmul(q, p) (tools/qLeft.m)."""
    w, v = q[..., :1], q[..., 1:]
    eye = jnp.eye(3, dtype=q.dtype)
    top = jnp.concatenate([w, -v], axis=-1)[..., None, :]
    bottom = jnp.concatenate(
        [v[..., :, None], w[..., None] * eye + mcross(v)], axis=-1
    )
    return jnp.concatenate([top, bottom], axis=-2)


def qright(q):
    """Right multiplication matrix: qright(q) @ p == qmul(p, q) (tools/qRight.m)."""
    w, v = q[..., :1], q[..., 1:]
    eye = jnp.eye(3, dtype=q.dtype)
    top = jnp.concatenate([w, -v], axis=-1)[..., None, :]
    bottom = jnp.concatenate(
        [v[..., :, None], w[..., None] * eye - mcross(v)], axis=-1
    )
    return jnp.concatenate([top, bottom], axis=-2)


def qinv(q):
    """Conjugate of a unit quaternion (tools/qInv.m)."""
    return jnp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quat_to_rmat(q):
    """Unit quaternion -> rotation matrix [..., 3, 3] (tools/quat2rmat.m)."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            q0**2 + q1**2 - q2**2 - q3**2,
            2 * (q1 * q2 - q0 * q3),
            2 * (q1 * q3 + q0 * q2),
            2 * (q1 * q2 + q0 * q3),
            q0**2 - q1**2 + q2**2 - q3**2,
            2 * (q2 * q3 - q0 * q1),
            2 * (q1 * q3 - q0 * q2),
            2 * (q2 * q3 + q0 * q1),
            q0**2 - q1**2 - q2**2 + q3**2,
        ],
        axis=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rmat_to_quat(R):
    """Rotation matrix -> quaternion (canonical sign).

    The reference goes through the matrix logarithm (tools/rmat2quat.m:34-37,
    tools/logR.m:28-29 with `logm`); here we use Shepperd's method — four
    candidate reconstructions keyed on the largest of
    {1±R00±R11±R22}, selected branch-free — which is numerically robust
    at every rotation angle and fully batched.
    """
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = jnp.stack(
        [
            1.0 + r00 + r11 + r22,  # 4 w^2
            1.0 + r00 - r11 - r22,  # 4 x^2
            1.0 - r00 + r11 - r22,  # 4 y^2
            1.0 - r00 - r11 + r22,  # 4 z^2
        ],
        axis=-1,
    )
    s = jnp.sqrt(jnp.clip(t, 1e-12, None))  # [..., 4] = 2*|component|
    a = R[..., 2, 1] - R[..., 1, 2]
    b = R[..., 0, 2] - R[..., 2, 0]
    c = R[..., 1, 0] - R[..., 0, 1]
    d = R[..., 0, 1] + R[..., 1, 0]
    e = R[..., 0, 2] + R[..., 2, 0]
    f = R[..., 1, 2] + R[..., 2, 1]
    sw, sx, sy, sz = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cand = jnp.stack(
        [
            jnp.stack([sw * sw, a, b, c], axis=-1) / (2.0 * sw[..., None]),
            jnp.stack([a, sx * sx, d, e], axis=-1) / (2.0 * sx[..., None]),
            jnp.stack([b, d, sy * sy, f], axis=-1) / (2.0 * sy[..., None]),
            jnp.stack([c, e, f, sz * sz], axis=-1) / (2.0 * sz[..., None]),
        ],
        axis=-2,
    )  # [..., 4 candidates, 4 components]
    best = jnp.argmax(t, axis=-1)
    q = jnp.take_along_axis(
        cand, best[..., None, None].repeat(4, axis=-1), axis=-2
    )[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(q[..., :1] < 0, -q, q)


def quat_to_euler(q):
    """Quaternion -> [yaw, pitch, roll] in degrees (tools/quat2euler.m:32-34)."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    e = jnp.stack(
        [
            jnp.arctan2(2 * (q2 * q3 - q0 * q1), 2 * (q0**2 + q3**2) - 1.0),
            -jnp.arcsin(jnp.clip(2 * (q1 * q3 + q0 * q2), -1.0, 1.0)),
            jnp.arctan2(2 * (q1 * q2 - q0 * q3), 2 * (q0**2 + q1**2) - 1.0),
        ],
        axis=-1,
    )
    return e * (180.0 / jnp.pi)
