"""Rao-Blackwellized particle smoother: conditional particle filter with
ancestor sampling (CPF-AS; the paper's Alg. 2, src/particleSmoother.m).

N_K sweeps of a conditional RBPF. Sweep 1 is a plain RBPF; in sweeps
k>1 particle N_P-1 is pinned to the reference trajectory sampled from the
previous sweep (:92-96,110-113) and its ancestor index is sampled from

    p(a) ∝ w_a · p(x'_t | x_a) · p(y_{t:T} | map_a)        (:171-233)

where the future-measurement likelihood evaluates the reference
trajectory's future observations against each particle's map posterior.

Device-oriented structure:

- each sweep is ONE jitted `lax.scan` over time with everything vmapped
  over particles; the per-sweep Python loop re-invokes the same compiled
  function with the new reference trajectory;
- dense path: the stacked future system (:188-193) is built at fixed
  width [T*ny, T*ny] with a time mask (rows ti < t neutralized exactly),
  so shapes stay static — the masked Cholesky equals the reference's
  dynamic-size one on the active block;
- sparse path: the reference stacks per-step EKF linearizations into an
  O((ny(T-t))^3) Cholesky (:194-218) — here the SAME Gaussian is
  evaluated through the matrix-inversion lemma in n_lin-dimensional
  information form (accumulate Lambda = sum H'R^-1H, iota = sum H'R^-1 e
  over future steps), which is exact and reduces the cost to one
  n_lin^3 Cholesky per particle per step;
- trajectories reconstructed from stored ancestor indices (vs the O(T^2)
  shuffle at :256-257).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from ..math.linalg import (
    gaussian_logpdf_chol,
    half_logdet,
    logsumexp_normalize,
    psd_cholesky,
    tril_solve,
)
from ..models.base import DenseModel, SparseModel
from ..ops.resampling import resample_indices, sample_categorical
from .rbpf import (
    _broadcast_time,
    _init_linear,
    _measurement_update,
    reconstruct_trajectories,
)

_LOG2PI = float(jnp.log(2.0 * jnp.pi))


class RBPSConfig(NamedTuple):
    n_particles: int
    n_sweeps: int
    resampling: str = "multinomial"
    jitter: float = 1e-2              # src/particleSmoother.m:70
    joseph: bool = False
    cov_dtype: str = "float32"        # bf16 covariance carry (dense path)
    symmetrize_cov: bool = True       # see RBPFConfig.symmetrize_cov
    # info-form ancestor weights: "woodbury" (default) maintains
    # W = (Imat+ImatAdd)^-1 and its log-det via exact rank-ny
    # updates/downdates (O(nl^2 ny) per particle-step — no factorization
    # in the hot loop); "cholesky" factorizes Imat+ImatAdd per particle
    # per step (the reference's structure, O(nl^3) batched cholesky +
    # triangular solves). Both forms sample matching trajectories
    # (equivalence gate
    # tests/test_rbps.py::test_woodbury_matches_cholesky_form).
    ancestor_form: str = "woodbury"
    # precompute the suffix information pairs for ALL t as one reverse
    # (associative) cumulative sum per sweep — the sequence-parallel
    # analog for this model class (SURVEY §5) and numerically cleaner
    # than the reference's accumulate-then-downdate (:194-201), which
    # cancels catastrophically for late t at f32. Costs [T, nl, nl]
    # memory on the cholesky form; set False to carry+downdate instead
    # (long-T, large-nl configs).
    suffix_precompute: bool = True


class RBPSResult(NamedTuple):
    XNK: jnp.ndarray   # [N_K, T, n_nonlin] sampled trajectories
    XLK: jnp.ndarray   # [N_K, n_lin] sampled map means
    PK: jnp.ndarray    # [N_K, n_lin, n_lin] sampled map covariances
    ess: jnp.ndarray   # [N_K, T]
    chol_retries: jnp.ndarray  # [N_K]


def _euclidean_residual(xn_ref, xn, u, dt, Q):
    """Default whitened dynamics residual (src/particleSmoother.m:175-180)."""
    L = jnp.linalg.cholesky(dt * Q)
    return tril_solve(L, xn_ref - xn - u[: xn.shape[0]])


def _dyn_log_weights(model, xnk_t, xn, u, dt_t, Q_t):
    """-0.5 ||e_dyn||^2 per particle (:175-182)."""
    res = model.dyn_residual or _euclidean_residual
    e = jax.vmap(lambda x: res(xnk_t, x, u, dt_t, Q_t))(xn)
    return -0.5 * jnp.sum(e * e, axis=-1)


def _dense_future_log_weights(
    C_stack, y_stack, t_idx, xl, P, R, T, ny, jitter
):
    """log N(y_{t:T}; C xl, C P C' + I⊗R) at fixed width with a time mask.

    C_stack: [T*ny, n_lin] Jacobians along the reference; y_stack: [T*ny].
    Rows with ti < t are neutralized (zero row, unit diagonal, zero
    innovation) — exactly equivalent to the reference's dynamic slice
    (src/particleSmoother.m:163-193).
    """
    step_ids = jnp.repeat(jnp.arange(T), ny)
    rmask = (step_ids >= t_idx).astype(C_stack.dtype)      # [T*ny]
    Cm = C_stack * rmask[:, None]
    R_blk = jnp.kron(jnp.eye(T, dtype=C_stack.dtype), R)
    outer = rmask[:, None] * rmask[None, :]

    def one(xl_i, P_i):
        S = Cm @ P_i @ Cm.T + R_blk * outer + jnp.diag(1.0 - rmask)
        e = (y_stack - Cm @ xl_i) * rmask
        L, retried = psd_cholesky(S, jitter)
        n_obs = jnp.sum(rmask)
        return gaussian_logpdf_chol(e, L, n_obs=n_obs), retried

    return jax.vmap(one)(xl, P)


def _sparse_future_log_weights(
    model, xnk, y, mask, t_idx, xl, P, R, jitter
):
    """Future-measurement log-likelihood, information form (exact).

    For each particle i, linearize the sparse model along the reference
    trajectory at the particle's current map (as src/particleSmoother.m:
    194-218) and evaluate the stacked Gaussian via the matrix inversion
    lemma: with Lambda = sum_ti H'R^-1H, iota = sum_ti H'R^-1 e,
    se = sum_ti e'R^-1 e (masked sums over ti >= t),

      log N = -0.5 (se - iota' (P^-1+Lambda)^-1 iota)
              -0.5 log|I + P Lambda| - 0.5 sum log|R_ti| - n_obs/2 log 2pi

    computed with B = I + L_P' Lambda L_P (one n_lin Cholesky of P and
    one of B per particle).
    """
    T = y.shape[0]
    r_diag = jnp.diagonal(R)

    def per_particle(xl_i, P_i):
        # linearize along the whole reference at this particle's map in
        # one vmapped sweep, then reduce with the (ti >= t) time mask —
        # same math as the reference's growing stacked system but fully
        # parallel over time (src/particleSmoother.m:194-218)
        yhat_all, H_all = jax.vmap(
            lambda xr: model.measure(xr, xl_i)
        )(xnk)                                           # [T, ny], [T, ny, nl]
        active = (jnp.arange(T) >= t_idx).astype(xl_i.dtype)
        m = mask * active[:, None]                       # [T, ny]
        Hm = H_all * m[:, :, None]
        e = (jnp.nan_to_num(y) - yhat_all) * m
        Lam = jnp.einsum("tkj,k,tki->ji", Hm, 1.0 / r_diag, Hm)
        iota = jnp.einsum("tkj,k,tk->j", Hm, 1.0 / r_diag, e)
        se = jnp.sum(e * e / r_diag[None, :])
        n_obs = jnp.sum(m)
        logdetR = jnp.sum(m * jnp.log(r_diag)[None, :])
        n_lin = xl_i.shape[0]
        Lp, r1 = psd_cholesky(P_i, jitter)
        B = jnp.eye(n_lin, dtype=xl_i.dtype) + Lp.T @ Lam @ Lp
        Lb, r2 = psd_cholesky(B, jitter)
        v = tril_solve(Lb, Lp.T @ iota)
        quad = se - jnp.sum(v * v)
        logw = (
            -0.5 * quad
            - half_logdet(Lb)
            - 0.5 * logdetR
            - 0.5 * n_obs * _LOG2PI
        )
        return logw, r1 | r2

    return jax.vmap(per_particle)(xl, P)


@partial(jax.jit, static_argnames=("model", "config", "is_first"))
def _cpf_as_sweep(
    key,
    model: Union[DenseModel, SparseModel],
    dx,
    y,
    mask,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPSConfig,
    xnk,          # [T, n_nonlin] reference trajectory (ignored if is_first)
    is_first: bool,
):
    """One conditional-particle-filter sweep. Returns
    (xnk', xlk', Pk', ess [T], retries)."""
    n_p = config.n_particles
    T = y.shape[0]
    dense = isinstance(model, DenseModel)
    ny = y.shape[1]
    xn0 = jnp.broadcast_to(
        jnp.asarray(x0_nonlin), (n_p,) + jnp.asarray(x0_nonlin).shape
    )
    if not is_first:
        xn0 = xn0.at[n_p - 1].set(xnk[0])          # pin (:92-96)
    xl0, P0 = _init_linear(x0_lin, P0_lin, n_p)
    n_lin = xl0.shape[-1]
    if dense and config.cov_dtype != "float32":
        P0 = P0.astype(jnp.dtype(config.cov_dtype))
    nl_c = xl0.shape[-1]   # carried linear dim

    if dense and not is_first:
        C_ref = jax.vmap(model.meas_jacobian)(xnk)     # [T, ny, n_lin] (:119-121)
        C_stack = C_ref.reshape(T * ny, nl_c)
        y_stack = jnp.nan_to_num(y).reshape(T * ny)
    else:
        C_stack = None
        y_stack = None

    # --- t = 0: importance weights + KF update only ---
    key, k0 = jax.random.split(key)
    xl1, P1, logw1, retries0 = _measurement_update(
        model, xn0, xl0, P0, jnp.nan_to_num(y[0]), R, mask[0],
        config.jitter, config.joseph, config.symmetrize_cov,
    )
    _, logw1n, _ = logsumexp_normalize(logw1)

    def step(carry, inputs):
        xn, xl, P, logw_n, retries = carry
        k, y_t, mask_t, u, Q_t, dt_t, t_idx = inputs
        k_res, k_dyn, k_anc = jax.random.split(k, 3)

        w = jnp.exp(logw_n)
        ai = resample_indices(k_res, w, n_p, config.resampling)

        if is_first:
            anc_last = ai[n_p - 1]
            retries_anc = jnp.zeros((), retries.dtype)
        else:
            # ancestor sampling for the pinned particle (:159-244)
            logw_dyn = _dyn_log_weights(model, xnk[t_idx], xn, u, dt_t, Q_t)
            if dense:
                logw_meas, retried = _dense_future_log_weights(
                    C_stack, y_stack, t_idx, xl, P, R, T, ny, config.jitter
                )
            else:
                logw_meas, retried = _sparse_future_log_weights(
                    model, xnk, y, mask, t_idx, xl, P, R, config.jitter
                )
            pa_log = logw_n + logw_dyn + logw_meas
            pa, _, _ = logsumexp_normalize(pa_log)
            anc_last = sample_categorical(k_anc, pa)
            retries_anc = jnp.sum(retried)

        ai = ai.at[n_p - 1].set(anc_last)
        xn_anc = jnp.take(xn, ai, axis=0)
        xl_anc = jnp.take(xl, ai, axis=0)

        if getattr(model, "dynamics_batch", None) is not None:
            # one batched noise draw instead of N_P per-particle key
            # splits + vmapped small lax.linalg factorizations (the
            # filter's pattern; same distribution, different stream)
            xn_new = model.dynamics_batch(k_dyn, xn_anc, u, dt_t, Q_t)
        else:
            dyn_keys = jax.random.split(k_dyn, n_p)
            xn_new = jax.vmap(
                lambda kk, x: model.dynamics(kk, x, u, dt_t, Q_t)
            )(dyn_keys, xn_anc)
        if not is_first:
            xn_new = xn_new.at[n_p - 1].set(xnk[t_idx])   # keep reference state

        P_anc = jnp.take(P, ai, axis=0)
        xl_new, P_new, logw, retried_kf = _measurement_update(
            model, xn_new, xl_anc, P_anc, y_t, R, mask_t,
            config.jitter, config.joseph, config.symmetrize_cov,
        )
        _, logw_nn, _ = logsumexp_normalize(logw)
        ess = jnp.exp(-jax.nn.logsumexp(2.0 * logw_nn))
        new_retries = retries + retries_anc + retried_kf
        return (
            (xn_new, xl_new, P_new, logw_nn, new_retries),
            (xn_new, ai.astype(jnp.int32), ess),
        )

    Qb, dtb = _broadcast_time(Q, dt, T)
    keys = jax.random.split(key, T - 1)
    inputs = (
        keys, jnp.nan_to_num(y[1:]), mask[1:], dx, Qb, dtb,
        jnp.arange(1, T),
    )
    carry0 = (xn0, xl1, P1, logw1n, retries0)
    (xn_f, xl_f, P_f, logw_f, retries), (xn_hist, ancestors, ess_t) = (
        jax.lax.scan(step, carry0, inputs)
    )

    xn_hist_full = jnp.concatenate([xn0[None], xn_hist], axis=0)
    xn_traj = reconstruct_trajectories(xn_hist_full, ancestors)

    # sample one trajectory + map (:346-354)
    key_pick = jax.random.fold_in(key, 7)
    ak = sample_categorical(key_pick, jnp.exp(logw_f))
    ess0 = jnp.exp(-jax.nn.logsumexp(2.0 * logw1n))
    xlk, Pk = xl_f[ak], P_f[ak].astype(jnp.float32)
    return (
        xn_traj[:, ak],
        xlk,
        Pk,
        jnp.concatenate([ess0[None], ess_t]),
        retries,
    )


def _run_sweeps(
    sweep_fn, key, model, dx, y, mask, x0_nonlin, x0_lin, P0_lin,
    Q, R, dt, config: RBPSConfig, checkpoint_dir: Optional[str],
) -> RBPSResult:
    """Shared sweep driver with per-sweep checkpoint/resume (the natural
    restart boundary, SURVEY §5; reference has no mid-run resume)."""
    T = y.shape[0]
    n_nonlin = jnp.asarray(x0_nonlin).shape[0]
    xnk = jnp.zeros((T, n_nonlin), dtype=y.dtype)

    XNK, XLK, PK, ESS, RET = [], [], [], [], []
    start_k = 0
    if checkpoint_dir is not None:
        from ..utils.checkpoint import latest_step, load_checkpoint

        step = latest_step(checkpoint_dir)
        if step is not None and step > 0:
            like = {
                "key": key,
                "xnk": xnk,
                "XNK": jnp.zeros((step, T, n_nonlin), y.dtype),
                "XLK": jnp.zeros(
                    (step, jnp.asarray(x0_lin).shape[-1]), y.dtype
                ),
                "PK": jnp.zeros(
                    (step,) + jnp.asarray(P0_lin).shape, y.dtype
                ),
                "ESS": jnp.zeros((step, T), y.dtype),
                "RET": jnp.zeros((step,), jnp.int32),
            }
            st = load_checkpoint(checkpoint_dir, step, like)
            key = jnp.asarray(st["key"])
            xnk = jnp.asarray(st["xnk"])
            XNK = [jnp.asarray(v) for v in st["XNK"]]
            XLK = [jnp.asarray(v) for v in st["XLK"]]
            PK = [jnp.asarray(v) for v in st["PK"]]
            ESS = [jnp.asarray(v) for v in st["ESS"]]
            RET = [jnp.asarray(v) for v in st["RET"]]
            start_k = min(step, config.n_sweeps)

    for k in range(start_k, config.n_sweeps):
        key, sub = jax.random.split(key)
        xnk, xlk, Pk, ess, retries = sweep_fn(
            sub, model, dx, y, mask, x0_nonlin, x0_lin, P0_lin,
            Q, R, dt, config, xnk, k == 0,
        )
        XNK.append(xnk)
        XLK.append(xlk)
        PK.append(Pk)
        ESS.append(ess)
        RET.append(retries)
        if checkpoint_dir is not None:
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_dir, k + 1,
                {
                    "key": key,
                    "xnk": xnk,
                    "XNK": jnp.stack(XNK),
                    "XLK": jnp.stack(XLK),
                    "PK": jnp.stack(PK),
                    "ESS": jnp.stack(ESS),
                    "RET": jnp.stack(RET),
                },
            )

    return RBPSResult(
        XNK=jnp.stack(XNK),
        XLK=jnp.stack(XLK),
        PK=jnp.stack(PK),
        ess=jnp.stack(ESS),
        chol_retries=jnp.stack(RET),
    )


def run_rbps(
    key,
    model: Union[DenseModel, SparseModel],
    dx,
    y,
    x0_nonlin,
    x0_lin,
    P0_lin,
    Q,
    R,
    dt,
    config: RBPSConfig,
    mask: Optional[jnp.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
) -> RBPSResult:
    """Run N_K CPF-AS sweeps (src/particleSmoother.m:88).

    COST WARNING (dense path): the naive ancestor weights build the full
    fixed-width [T*ny, T*ny] masked stacked system per particle per step
    — O(N_K N_T N_P (T ny)^3) total, the cost blowup the reference's
    information form exists to remove (src/particleSmoother.m:221-229;
    SURVEY §3.2). For dense models beyond small T (e.g. the dense-mag
    T=192, ny=3 config) use :func:`run_rbps_information_form` — this
    engine is the semantics reference and the sparse-features smoother.
    """
    y = jnp.asarray(y)
    if isinstance(model, DenseModel) and y.shape[0] * model.ny > 256:
        import warnings

        warnings.warn(
            f"run_rbps dense ancestor weights factorize a "
            f"[{y.shape[0] * model.ny}]^2 stacked system per particle "
            "per step (O((T ny)^3)); use run_rbps_information_form at "
            "this scale",
            stacklevel=2,
        )
    if mask is None:
        mask = jnp.isfinite(y).astype(y.dtype)
    if isinstance(model, SparseModel):
        # full-f32 matmul passes for the ill-conditioned sparse/EKF
        # algebra — see run_rbpf's SparseModel note (reduced-precision
        # TF32 passes can produce NaN weights at reference scale)
        with jax.default_matmul_precision("highest"):
            return _run_sweeps(
                _cpf_as_sweep, key, model, dx, y, mask, x0_nonlin,
                x0_lin, P0_lin, Q, R, dt, config, checkpoint_dir,
            )
    return _run_sweeps(
        _cpf_as_sweep, key, model, dx, y, mask, x0_nonlin, x0_lin,
        P0_lin, Q, R, dt, config, checkpoint_dir,
    )
