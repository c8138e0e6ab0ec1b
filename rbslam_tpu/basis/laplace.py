"""Laplacian eigenbasis on a centered hypercube with Dirichlet boundaries.

Reduced-rank GP machinery (Solin & Särkkä 2020 Hilbert-space method), with
the same math as the reference (tools/domain_cartesian_dx.m):

- eigenvalues  ``lambda(n) = sum_j (pi * n_j / (2 L_j))^2``  (:40)
- eigenfunctions ``phi_n(x) = prod_j L_j^{-1/2} sin(pi n_j (x_j + L_j)/(2 L_j))``
  (:88-93), with analytic first (:146-170) and second derivatives
  (tools/JacobianPhi3D.m:43-64).

Index selection (over-generate a grid of ``ceil(m^(1/d) * L/min(L))`` per
dimension, keep the m smallest eigenvalues, :33-43) happens **at trace
time with numpy** — the index set is static data baked into the jitted
program, so the device only ever sees fixed-shape sin/cos product
evaluations, kept as one elementwise expression that XLA fuses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp


def _ndgrid_indices(N: np.ndarray) -> np.ndarray:
    """All index combinations 1..N_j per dimension (domain_cartesian_dx.m:174-218)."""
    axes = [np.arange(1, n + 1) for n in N]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def select_indices(m: int, L: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pick the m index tuples with smallest eigenvalues.

    Ties are broken by index order, matching MATLAB's stable sort of the
    over-generated grid (domain_cartesian_dx.m:43).
    Returns ``(NN [m, d] int32, eigenvalues [m] float64)``.
    """
    L = np.asarray(L, dtype=np.float64).reshape(-1)
    d = L.shape[0]
    N = np.ceil(m ** (1.0 / d) * L / np.min(L)).astype(int)
    NN = _ndgrid_indices(N)
    lam = np.sum((np.pi * NN / (2.0 * L)) ** 2, axis=-1)
    order = np.argsort(lam, kind="stable")[:m]
    return NN[order].astype(np.int32), lam[order]


@dataclass(frozen=True)
class LaplaceBasis:
    """Static eigenbasis: index set NN, half-widths L, eigenvalues."""

    NN: np.ndarray          # [m, d] int32 (static)
    L: np.ndarray           # [d] float64 half-widths (static)
    eigenvalues: np.ndarray  # [m] float64 (static)

    @property
    def m(self) -> int:
        return int(self.NN.shape[0])

    @property
    def d(self) -> int:
        return int(self.NN.shape[1])

    def _args(self, x, dtype):
        """Phase arguments a[..., m, d] = pi n_j (x_j + L_j) / (2 L_j)."""
        NN = jnp.asarray(self.NN, dtype=dtype)            # [m, d]
        L = jnp.asarray(self.L, dtype=dtype)              # [d]
        shifted = (x + L)[..., None, :]                   # [..., 1, d]
        return jnp.pi * NN * shifted / (2.0 * L), NN, L

    def phi(self, x):
        """Eigenfunctions at x [..., d] -> [..., m]."""
        dtype = x.dtype
        a, _, L = self._args(x, dtype)
        scale = jnp.prod(1.0 / jnp.sqrt(L))
        return scale * jnp.prod(jnp.sin(a), axis=-1)

    def dphi(self, x, di: int):
        """d phi / d x_di at x [..., d] -> [..., m] (domain_cartesian_dx.m:146-170)."""
        dtype = x.dtype
        a, NN, L = self._args(x, dtype)
        scale = jnp.prod(1.0 / jnp.sqrt(L))
        trig = jnp.sin(a).at[..., di].set(jnp.cos(a[..., di]))
        fac = jnp.pi * NN[:, di] / (2.0 * L[di])
        return scale * fac * jnp.prod(trig, axis=-1)

    def grad_phi(self, x):
        """All first derivatives stacked: [..., d, m].

        Closed-form fused evaluation: ONE sin and ONE cos pass over the
        [..., m, d] phase array, then per-dimension products with the cos
        plane swapped in — ~3x fewer transcendentals and no scatter vs
        evaluating :meth:`dphi` per dimension (the hot op of the RBPF
        measurement Jacobian, SURVEY §3.1 basis-eval cost).
        """
        dtype = x.dtype
        a, NN, L = self._args(x, dtype)
        scale = jnp.prod(1.0 / jnp.sqrt(L))
        s = jnp.sin(a)                                    # [..., m, d]
        c = jnp.cos(a)
        fac = jnp.pi * NN / (2.0 * jnp.asarray(self.L, dtype=dtype))  # [m, d]
        if self.d == 1:
            return (scale * fac[:, 0] * c[..., 0])[..., None, :]
        # prefix/suffix sin products so each dim's product is O(1) muls
        rows = []
        for i in range(self.d):
            prod = c[..., i]
            for j in range(self.d):
                if j != i:
                    prod = prod * s[..., j]
            rows.append(scale * fac[:, i] * prod)
        return jnp.stack(rows, axis=-2)

    def hess_phi(self, x):
        """Second derivatives d^2 phi / (dx_i dx_j): [..., d, d, m].

        The Hessian of each eigenfunction — the pose block of the dense
        EKF measurement Jacobian (tools/JacobianPhi3D.m:43-64).
        """
        dtype = x.dtype
        a, NN, L = self._args(x, dtype)
        scale = jnp.prod(1.0 / jnp.sqrt(L))
        s = jnp.sin(a)   # [..., m, d]
        c = jnp.cos(a)
        fac = jnp.pi * NN / (2.0 * jnp.asarray(self.L, dtype=dtype))  # [m, d]
        rows = []
        for i in range(self.d):
            cols = []
            for j in range(self.d):
                trig = s
                if i == j:
                    # d^2/dx_i^2: -f_i^2 * (product with sin in dim i)
                    val = -(fac[:, i] ** 2) * jnp.prod(trig, axis=-1)
                else:
                    trig = trig.at[..., i].set(c[..., i])
                    trig = trig.at[..., j].set(c[..., j])
                    val = fac[:, i] * fac[:, j] * jnp.prod(trig, axis=-1)
                cols.append(scale * val)
            rows.append(jnp.stack(cols, axis=-2))
        return jnp.stack(rows, axis=-3)


def hypercube_basis(m: int, LL) -> LaplaceBasis:
    """Build a basis from domain bounds.

    ``LL`` is either half-widths ``[d]`` (domain ``[-L, L]^d``) or bounds
    ``[2, d]`` rows ``(min, max)`` — in that case the domain is centered
    first (domain_cartesian_dx.m:27-29); callers are responsible for
    shifting inputs by the center (gp_rnd_SE1D_fast.m:47-49).
    """
    LL = np.asarray(LL, dtype=np.float64)
    if LL.ndim > 1:
        L = (LL[1] - LL[0]) / 2.0
    else:
        L = LL
    NN, lam = select_indices(m, L)
    return LaplaceBasis(NN=NN, L=np.asarray(L), eigenvalues=lam)


def domain_center(LL) -> np.ndarray:
    """Center of a (min,max) bounds array [2, d]."""
    LL = np.asarray(LL, dtype=np.float64)
    return np.mean(LL, axis=0)
