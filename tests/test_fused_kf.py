"""The factored-carry KF update (kf_kernel="lowrank") and its gather-CP
kernel match the XLA path: the plain versions and the Pallas/Triton
kernel in the interpreter on the CPU, the compiled kernel on the card
(``gpu`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rbslam_tpu.engines import RBPFConfig, run_rbpf
from rbslam_tpu.ops.kalman import kalman_update_dense_batched

from test_rbpf import _radio_setup, THETA


def _spd_batch(ny, n=64, seed=0):
    """PD [n, ny, ny] matrices with eigenvalues spread over 1..1e4."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, ny, ny)))
    d = np.geomspace(1.0, 1e4, ny)[None, :] * np.ones((n, 1))
    return np.einsum("bij,bj,bkj->bik", Q, d, Q).astype(np.float32)


@pytest.mark.parametrize("ny", [1, 2, 3])
def test_chol_small_accuracy(ny):
    """The closed-form small-ny Cholesky and its inverse factor (the
    whitener of the factored update's new rows, S^-1 = Li' Li) match
    LAPACK on PD inputs across conditioning."""
    from rbslam_tpu.ops.kalman import (
        _chol_small_batched,
        _Li_from_chol_small_batched,
    )

    S = _spd_batch(ny)
    L, bad = _chol_small_batched(jnp.asarray(S), 1e-3)
    Li = _Li_from_chol_small_batched(L)
    L, bad, Li = map(np.asarray, (L, bad, Li))
    assert not bad.any()
    S64 = S.astype(np.float64)
    np.testing.assert_allclose(
        L, np.linalg.cholesky(S64), atol=2e-3 * np.sqrt(1e4)
    )
    logdet = 2.0 * np.log(np.diagonal(L, axis1=-2, axis2=-1)).sum(-1)
    np.testing.assert_allclose(logdet, np.linalg.slogdet(S64)[1], atol=5e-3)
    inv_ref = np.linalg.inv(S64)
    np.testing.assert_allclose(
        np.einsum("bki,bkj->bij", Li, Li), inv_ref,
        atol=5e-3 * np.abs(inv_ref).max(),
    )


@pytest.mark.parametrize("ny", [1, 2, 3])
def test_chol_small_repairs_indefinite(ny):
    """Indefinite / zero S: flagged bad, jitter-shifted, and ALWAYS
    finite (a single NaN particle would poison the ensemble logsumexp)."""
    from rbslam_tpu.ops.kalman import (
        _chol_small_batched,
        _Li_from_chol_small_batched,
    )

    rng = np.random.default_rng(1)
    A = rng.normal(size=(32, ny, ny)).astype(np.float32)
    S_indef = A @ A.transpose(0, 2, 1) - 5.0 * np.eye(ny, dtype=np.float32)
    for S in (S_indef, np.zeros((8, ny, ny), np.float32)):
        L, bad = _chol_small_batched(jnp.asarray(S), 1e-3)
        Li = _Li_from_chol_small_batched(L)
        assert np.isfinite(np.asarray(L)).all()
        assert np.isfinite(np.asarray(Li)).all()
        assert np.asarray(bad).any()


def _factored_problem(N, ny, nl, rw, dtype, seed=0):
    """Random factored-carry operands in the storage dtype."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    A = jax.random.normal(ks[0], (N, nl, nl)) * 0.2
    P_base = (jnp.einsum("pij,pkj->pik", A, A) + 2.0 * jnp.eye(nl))
    Wt = 0.1 * jax.random.normal(ks[1], (N, rw, nl))
    C = 0.3 * jax.random.normal(ks[2], (N, ny, nl))
    bidx = jax.random.randint(ks[3], (N,), 0, N)
    dt = jnp.dtype(dtype)
    return bidx, C.astype(dt), Wt.astype(dt), P_base.astype(dt)


def _materialized(bidx, C, Wt, P_base):
    """float64 P_eff = P_base[bidx] - Wt^T Wt and CP = C P_eff."""
    f64 = lambda a: np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    Wt64 = f64(Wt)
    P_eff = f64(P_base)[np.asarray(bidx)] - np.einsum(
        "pri,prj->pij", Wt64, Wt64
    )
    return P_eff, np.einsum("pij,pjk->pik", f64(C), P_eff)


_CASES = [(ny, dt) for ny in (1, 2, 3) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("ny,dtype", _CASES)
def test_plain_gather_cp_and_rebase(ny, dtype):
    """The plain gather-CP contraction and rebase (the CPU path and the
    reference the card's kernel is held to) against the materialized P."""
    from rbslam_tpu.kernels import gather_cp_reference, kf_rebase

    bidx, C, Wt, P_base = _factored_problem(24, ny, 40, 8 * ny, dtype)
    P_eff, CP_ref = _materialized(bidx, C, Wt, P_base)
    CP = np.asarray(jax.jit(gather_cp_reference)(bidx, C, Wt, P_base))
    assert CP.shape == (24, ny, 40) and CP.dtype == np.float32
    np.testing.assert_allclose(CP, CP_ref, atol=1e-5 * np.abs(CP_ref).max())
    P_new = jax.jit(kf_rebase)(bidx, Wt, P_base)   # plain on the CPU
    assert P_new.dtype == P_base.dtype
    # the rebased P is rounded once to the storage dtype
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(
        np.asarray(P_new.astype(jnp.float32)), P_eff,
        atol=tol * np.abs(P_eff).max(),
    )


@pytest.mark.parametrize(
    "N,ny,nl,rw,dtype",
    [(16, ny, 128, 8 * ny, dt) for ny, dt in _CASES]
    + [(7, 3, 77, 20, "float32")],          # odd N, ragged nl and rw
)
def test_gather_cp_kernel_interpret(N, ny, nl, rw, dtype):
    """The Pallas/Triton gather-CP kernel, run by the Pallas interpreter,
    matches the materialized-P reference (masks cover ragged nl/rw)."""
    from rbslam_tpu.kernels.kf_update import gather_cp_pallas

    bidx, C, Wt, P_base = _factored_problem(N, ny, nl, rw, dtype, seed=N)
    _, CP_ref = _materialized(bidx, C, Wt, P_base)
    CP = np.asarray(gather_cp_pallas(bidx, C, Wt, P_base, interpret=True))
    assert CP.shape == (N, ny, nl) and CP.dtype == np.float32
    np.testing.assert_allclose(CP, CP_ref, atol=1e-5 * np.abs(CP_ref).max())


@pytest.mark.parametrize(
    "N,nl,rw,dtype",
    [(6, 128, 24, "float32"), (6, 128, 24, "bfloat16"),
     (5, 77, 3, "float32")],                # odd N, ragged nl and rw
)
def test_rebase_kernel_interpret(N, nl, rw, dtype):
    """The Pallas/Triton rebase kernel, run by the Pallas interpreter,
    matches the materialized P_base[bidx] - Wt^T Wt, rounded once to the
    storage dtype."""
    from rbslam_tpu.kernels.kf_update import rebase_pallas

    bidx, _, Wt, P_base = _factored_problem(N, 3, nl, rw, dtype, seed=N)
    P_eff, _ = _materialized(bidx, jnp.zeros((N, 1, nl)), Wt, P_base)
    out = rebase_pallas(bidx, Wt, P_base, interpret=True)
    assert out.shape == (N, nl, nl) and out.dtype == P_base.dtype
    tol = 1e-6 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(np.asarray(out.astype(jnp.float32)), P_eff,
                               atol=tol * np.abs(P_eff).max())


@pytest.mark.gpu
@pytest.mark.parametrize("nl,dtype", [(128, "bfloat16"), (515, "float32")])
def test_kernels_on_card(nl, dtype):
    """The kernels as compiled for the card (gather_cp and kf_rebase lower
    to Triton on CUDA) against the plain versions at highest precision."""
    from rbslam_tpu.kernels import kf_update

    bidx, C, Wt, P_base = _factored_problem(256, 3, nl, 24, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for kernel, reference, args in (
        (kf_update.gather_cp, kf_update.gather_cp_reference,
         (bidx, C, Wt, P_base)),
        (kf_update.kf_rebase, kf_update.rebase_reference,
         (bidx, Wt, P_base)),
    ):
        out = jax.jit(kernel)(*args).astype(jnp.float32)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(reference)(*args).astype(jnp.float32)
        scale = float(jnp.abs(ref).max())
        assert float(jnp.abs(out - ref).max()) <= tol * scale


def test_kernel_paths_reject_masked_y():
    """NaN-masked observations must be rejected on the factored path (it
    has no mask support and would silently treat NaN as y=0 — ADVICE
    round 3); the xla path handles the same input via the masked
    update."""
    data, model, basis, center, k, Q = _radio_setup()
    y_nan = np.asarray(data.y).copy()
    y_nan[3, 0] = np.nan
    args = (
        model, data.dx, jnp.asarray(y_nan), data.init_state,
        jnp.zeros(basis.m), jnp.diag(k), Q,
        jnp.array([[THETA[2]]]), 1.0,
    )
    with pytest.raises(ValueError, match="NaN"):
        run_rbpf(
            jax.random.PRNGKey(0), *args,
            RBPFConfig(n_particles=8, kf_kernel="lowrank",
                       symmetrize_cov=False),
        )
    # explicit non-trivial mask is rejected too
    mask = jnp.ones_like(data.y).at[2, 0].set(0.0)
    with pytest.raises(ValueError, match="mask"):
        run_rbpf(
            jax.random.PRNGKey(0), model, data.dx, data.y,
            data.init_state, jnp.zeros(basis.m), jnp.diag(k), Q,
            jnp.array([[THETA[2]]]), 1.0,
            RBPFConfig(n_particles=8, kf_kernel="lowrank",
                       symmetrize_cov=False),
            mask=mask,
        )


def test_unknown_kf_kernel_rejected():
    data, model, basis, center, k, Q = _radio_setup()
    with pytest.raises(ValueError, match="kf_kernel"):
        run_rbpf(
            jax.random.PRNGKey(0), model, data.dx, data.y,
            data.init_state, jnp.zeros(basis.m), jnp.diag(k), Q,
            jnp.array([[THETA[2]]]), 1.0,
            RBPFConfig(n_particles=8, kf_kernel="block"),
        )


@pytest.mark.parametrize("ny", [1, 2, 3])
def test_lowrank_kernel_matches_reference(ny):
    """Factored update (P = P_base - Wt^T Wt) == XLA update on the
    materialized covariance, and kf_rebase reproduces the XLA P'
    (nl=130: no tile-multiple width is needed)."""
    from rbslam_tpu.kernels.kf_update import kf_rebase, kf_update_lowrank

    key = jax.random.PRNGKey(3)
    N, nl, rw = 32, 130, 8 * ny
    ks = jax.random.split(key, 6)
    A = jax.random.normal(ks[0], (N, nl, nl)) * 0.2
    P_base = jnp.einsum("pij,pkj->pik", A, A) + 2.0 * jnp.eye(nl)
    Wt = jnp.zeros((N, rw, nl)).at[:, :2 * ny].set(
        0.1 * jax.random.normal(ks[1], (N, 2 * ny, nl))
    )
    C = jax.random.normal(ks[2], (N, ny, nl)) * 0.3
    xl = jax.random.normal(ks[3], (N, nl))
    y = jax.random.normal(ks[4], (ny,))
    R = 0.5 * jnp.eye(ny)
    bidx = jax.random.randint(ks[5], (N,), 0, N)

    P_eff = jnp.take(P_base, bidx, 0) - jnp.einsum("pri,prj->pij", Wt, Wt)
    ref = kalman_update_dense_batched(C, P_eff, xl, y, R, 1e-3, False, False)
    xl_new, wnew, logw, bad = kf_update_lowrank(bidx, C, xl, Wt, P_base, y, R)
    np.testing.assert_allclose(xl_new, ref[0], atol=5e-2)
    np.testing.assert_allclose(logw, ref[2], atol=5e-2)
    assert not bool(bad.any())

    Wt2 = jax.lax.dynamic_update_slice(Wt, wnew, (0, 2 * ny, 0))
    P_new = kf_rebase(bidx, Wt2, P_base)
    np.testing.assert_allclose(
        np.asarray(P_new), np.asarray(ref[1]), atol=5e-2
    )


def test_lowrank_kernel_jitter_retry():
    """A non-PD effective S triggers the same scale-aware jitter repair
    and bad flag as the XLA path."""
    from rbslam_tpu.kernels.kf_update import kf_update_lowrank

    N, ny, nl, rw = 8, 3, 128, 24
    # P_base = 0 and R = 0 -> S = 0: every particle must be flagged
    P_base = jnp.zeros((N, nl, nl))
    Wt = jnp.zeros((N, rw, nl))
    C = jax.random.normal(jax.random.PRNGKey(0), (N, ny, nl)) * 0.3
    xl = jnp.zeros((N, nl))
    y = jnp.ones((ny,))
    R = jnp.zeros((ny, ny))
    xl_new, wnew, logw, bad = kf_update_lowrank(
        jnp.arange(N), C, xl, Wt, P_base, y, R
    )
    assert bool(bad.all())
    assert np.isfinite(np.asarray(logw)).all()


def test_rbpf_lowrank_equivalent():
    """Full filter run: kf_kernel='lowrank' == 'xla' (the factored path
    materializes P only at rebases). T=12 spans one full rebase period
    (r=8) plus a remainder scan."""
    data, model, basis, center, k, Q = _radio_setup()
    base = dict(n_particles=16, resampling="systematic",
                symmetrize_cov=False)
    args = (
        model, data.dx, data.y, data.init_state,
        jnp.zeros(basis.m), jnp.diag(k), Q,
        jnp.array([[THETA[2]]]), 1.0,
    )
    res_a = run_rbpf(
        jax.random.PRNGKey(0), *args,
        RBPFConfig(**base, kf_kernel="xla"),
    )
    res_b = run_rbpf(
        jax.random.PRNGKey(0), *args,
        RBPFConfig(**base, kf_kernel="lowrank"),
    )
    np.testing.assert_allclose(
        np.asarray(res_a.traj_mean), np.asarray(res_b.traj_mean), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_a.xl_mean), np.asarray(res_b.xl_mean), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_a.P_mean), np.asarray(res_b.P_mean), atol=5e-3
    )


def test_rbpf_lowrank_ess_adaptive_equivalent():
    """ESS-gated resampling on the factored path (VERDICT r4 #9): with
    ess_threshold < 1 a no-resample step keeps ai = identity (composing
    with the carried base indices) and accumulates log-weights; the run
    must match the xla path step-for-step (same keys, same
    resampling decisions) and actually skip some resampling steps."""
    data, model, basis, center, k, Q = _radio_setup()
    base = dict(n_particles=16, resampling="systematic",
                symmetrize_cov=False, ess_threshold=0.7)
    args = (
        model, data.dx, data.y, data.init_state,
        jnp.zeros(basis.m), jnp.diag(k), Q,
        jnp.array([[THETA[2]]]), 1.0,
    )
    res_a = run_rbpf(
        jax.random.PRNGKey(0), *args,
        RBPFConfig(**base, kf_kernel="xla"),
    )
    res_b = run_rbpf(
        jax.random.PRNGKey(0), *args,
        RBPFConfig(**base, kf_kernel="lowrank"),
    )
    # identical resampling decisions and ancestors
    np.testing.assert_array_equal(
        np.asarray(res_a.ancestors), np.asarray(res_b.ancestors)
    )
    ident = np.arange(16)
    skipped = [
        (np.asarray(res_b.ancestors[t]) == ident).all()
        for t in range(res_b.ancestors.shape[0])
    ]
    assert any(skipped), "expected at least one ESS-skipped step"
    assert not all(skipped), "expected at least one resampling step"
    np.testing.assert_allclose(
        np.asarray(res_a.traj_mean), np.asarray(res_b.traj_mean), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_a.logw), np.asarray(res_b.logw), atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(res_a.xl_mean), np.asarray(res_b.xl_mean), atol=5e-3
    )


def test_rbpf_lowrank_T1_falls_back():
    """T == 1 (zero scan steps) used to crash the lowrank path on an
    empty outs concat (ADVICE round 3); it now routes through the
    generic scan and matches the XLA path."""
    data, model, basis, center, k, Q = _radio_setup()
    base = dict(n_particles=8, resampling="systematic",
                symmetrize_cov=False)
    Q1 = Q[:0] if jnp.asarray(Q).ndim == 3 else Q
    args = (
        model, data.dx[:0], data.y[:1], data.init_state,
        jnp.zeros(basis.m), jnp.diag(k), Q1,
        jnp.array([[THETA[2]]]), 1.0,
    )
    res_a = run_rbpf(jax.random.PRNGKey(0), *args, RBPFConfig(**base))
    res_b = run_rbpf(
        jax.random.PRNGKey(0), *args, RBPFConfig(**base, kf_kernel="lowrank")
    )
    np.testing.assert_allclose(
        np.asarray(res_a.xl_mean), np.asarray(res_b.xl_mean), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res_a.logw), np.asarray(res_b.logw), atol=1e-5
    )
