"""Model protocol: functional state-space models with explicit PRNG keys.

The reference injects MATLAB closures that draw their own noise
(`dynModel(xn,dx,dt,Q)` with `randn` inside, run_dense2D_withHeading.m:75-76)
and a measurement handle whose signature differs between the dense
(`dy = measModel(xn)`) and sparse (`[yhat,dy] = measModel(xn,xl)`) paths
(src/particleFilter.m:12-14,123-136). This contract keeps those
semantics but:

- noise is sampled from an explicit `key` (reproducible across shardings),
- every callable is written for ONE particle and `vmap`-ed by the engines,
- the sparse path returns a fixed-width visibility/validity story via the
  data-side NaN mask (engines combine it with `~isnan(y_t)`).

All callables must be jit-traceable (static shapes, no Python branching
on traced values).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class DenseModel(NamedTuple):
    """Conditionally linear measurement: y = C(xn) @ xl + r.

    dynamics:      (key, xn, u, dt, Q) -> xn'        sampled transition
    dyn_residual:  (xn_ref, xn, u, dt, Q) -> e       whitened dynamics
                   residual for ancestor weights (None -> Euclidean
                   default, src/particleSmoother.m:175-180)
    meas_jacobian: (xn) -> C [ny, n_lin]
    n_nonlin, n_lin, ny: static dimensions
    """

    dynamics: Callable
    dyn_residual: Optional[Callable]
    meas_jacobian: Callable
    n_nonlin: int
    n_lin: int
    ny: int
    # optional whole-ensemble transition (key, xn [P, dn], u, dt, Q) ->
    # xn' [P, dn]: one key and one batched noise draw instead of P
    # per-particle key splits (threefry key derivation for 16k+ particles
    # is measurable work in the hot step)
    dynamics_batch: Optional[Callable] = None


class SparseModel(NamedTuple):
    """Conditionally linearized (EKF) measurement.

    dynamics:     (key, xn, u, dt, Q) -> xn'
    dyn_residual: optional whitened residual (None -> Euclidean default)
    measure:      (xn, xl) -> (yhat [ny], H [ny, n_lin])  linearization at
                  the particle's current map (src/particleFilter.m:129)
    """

    dynamics: Callable
    dyn_residual: Optional[Callable]
    measure: Callable
    n_nonlin: int
    n_lin: int
    ny: int
