"""The jnp basis and Jacobian evaluation (the path on every platform)
against an independent NumPy closed form, plus the small-ny Cholesky
repair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rbslam_tpu.basis import ScalarPotentialBasis, hypercube_basis


def _np_phi_grad(x, NN, L):
    """float64 closed form (tools/domain_cartesian_dx.m:88-93,146-170):
    phi_n = prod_j L_j^-1/2 sin(w_nj (x_j + L_j)), w_nj = pi n_j / (2 L_j);
    d phi_n / d x_i swaps sin for w_ni cos in dimension i."""
    x = np.asarray(x, np.float64)
    NN = np.asarray(NN, np.float64)
    L = np.asarray(L, np.float64)
    w = np.pi * NN / (2.0 * L)                       # [m, d]
    a = w[None] * (x[:, None, :] + L)                # [N, m, d]
    scale = np.prod(1.0 / np.sqrt(L))
    s, c = np.sin(a), np.cos(a)
    phi = scale * np.prod(s, axis=-1)                # [N, m]
    d = NN.shape[1]
    grad = np.stack([
        scale * w[None, :, i] * c[..., i]
        * np.prod(np.delete(s, i, axis=-1), axis=-1)
        for i in range(d)
    ], axis=1)                                       # [N, d, m]
    return phi, grad


def _np_quat_to_rmat(q):
    """Scalar-first unit quaternion -> rotation matrix (float64)."""
    q0, q1, q2, q3 = np.moveaxis(np.asarray(q, np.float64), -1, 0)
    return np.stack([
        np.stack([q0**2 + q1**2 - q2**2 - q3**2, 2 * (q1 * q2 - q0 * q3),
                  2 * (q1 * q3 + q0 * q2)], -1),
        np.stack([2 * (q1 * q2 + q0 * q3), q0**2 - q1**2 + q2**2 - q3**2,
                  2 * (q2 * q3 - q0 * q1)], -1),
        np.stack([2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
                  q0**2 - q1**2 - q2**2 + q3**2], -1),
    ], -2)


_BASES = {
    2: (16, np.array([3.0, 3.0]), 300),
    3: (50, np.array([2.0, 1.5, 1.0]), 37),
}


@pytest.mark.parametrize("d", [2, 3])
def test_phi_matches_numpy(d):
    m, L, n = _BASES[d]
    basis = hypercube_basis(m, L)
    x = jax.random.uniform(jax.random.PRNGKey(d), (n, d),
                           minval=-0.9 * L, maxval=0.9 * L)
    ref, _ = _np_phi_grad(x, basis.NN, basis.L)
    np.testing.assert_allclose(np.asarray(basis.phi(x)), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_grad_phi_matches_numpy(d):
    m, L, n = _BASES[d]
    basis = hypercube_basis(m, L)
    x = jax.random.uniform(jax.random.PRNGKey(10 + d), (n, d),
                           minval=-0.9 * L, maxval=0.9 * L)
    _, ref = _np_phi_grad(x, basis.NN, basis.L)
    out = np.asarray(basis.grad_phi(x))
    assert out.shape == (n, d, m)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=1e-3)


def test_mag3d_batched_jacobian_matches_numpy():
    """The engines' whole-ensemble Jacobian, vmap(meas_jacobian), equals
    C = R(q)^T [I3 | grad phi(p - c)] (run_dense3D_magfield.m:265-279)."""
    from rbslam_tpu.models import make_mag3d_model

    basis = hypercube_basis(61, np.array([2.0, 2.0, 1.0]))
    center = np.array([0.3, -0.2, 0.1])
    model = make_mag3d_model(ScalarPotentialBasis(basis),
                             center=jnp.asarray(center, jnp.float32))
    kp, kq = jax.random.split(jax.random.PRNGKey(7))
    n = 37
    pos = jax.random.uniform(kp, (n, 3), minval=-1.5, maxval=1.5)
    q = jax.random.normal(kq, (n, 4))
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    xn = jnp.concatenate([pos + jnp.asarray(center, jnp.float32), q], -1)

    C = np.asarray(jax.jit(jax.vmap(model.meas_jacobian))(xn))
    assert C.shape == (n, 3, 3 + basis.m)
    _, g = _np_phi_grad(np.asarray(pos), basis.NN, basis.L)
    C_nav = np.concatenate([np.broadcast_to(np.eye(3), (n, 3, 3)), g], -1)
    ref = np.einsum("pji,pjk->pik", _np_quat_to_rmat(q), C_nav)
    np.testing.assert_allclose(C, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_chol_small_scale_aware_jitter():
    """A non-PD innovation at magnetic-field scale (diag ~1e3) must be
    repaired by the retry even though 1e-3 absolute jitter is below one
    bf16 ulp there (the retry scales by the mean diagonal)."""
    from rbslam_tpu.ops.kalman import _chol_small_batched

    # rank-1 (singular) S at scale 1e3, slightly indefinite in bf16
    v = jnp.asarray([30.0, 20.0, 10.0])
    S = jnp.tile((jnp.outer(v, v)), (4, 1, 1))
    S = S - 1e-2 * jnp.eye(3)          # indefinite
    S16 = S.astype(jnp.bfloat16).astype(jnp.float32)
    L, bad = _chol_small_batched(S16, 1e-3)
    assert bool(jnp.all(bad))
    assert bool(jnp.all(jnp.isfinite(L))), np.asarray(L)
    # the repaired factor reproduces S up to the added jitter scale
    rec = L @ jnp.swapaxes(L, -1, -2)
    assert bool(jnp.all(jnp.isfinite(rec)))
