"""Factored-carry KF update for the RBPF hot loop: P = P_base - Wt^T Wt.

The KF covariance downdate is additive rank-ny per step
(src/particleFilter.m:194-198):

    P_t = P_base - sum_tau U_tau S_tau^-1 U_tau^T = P_base - Wt^T Wt,
    Wt rows at step tau: Y_tau = L_tau^-1 C_tau P_tau   (S = L L^T)

so the filter carries the FACTOR Wt [rw, nl] (rw = ny * rebase period)
instead of P, and materializes P ("rebase") only every r steps. Per
step the update reads the ancestor's P_base row (read-only between
rebases, gathered by composed base indices and never rewritten), reads
the small factor, and writes ny new factor rows.

The per-step hot op is the gather-fused effective-CP contraction

    CP[b] = C[b] (P_base[bidx[b]] - Wt[b]^T Wt[b])

a memory-bound batched GEMV (ny <= 3 rows). On CUDA it runs as a
Pallas/Triton kernel that streams each ancestor row straight from
P_base; the plain version (:func:`gather_cp_reference`) materializes the
gathered [N, nl, nl] tensor first and serves the CPU. The once-per-
period rebase P_base' = P_base[bidx] - Wt^T Wt likewise has a Triton
kernel (gather, rank-rw product and subtraction in one pass) and a plain
version. The small-ny algebra after the contraction (closed-form
Cholesky, weights, gain) is plain XLA. ny is restricted to 1..3 (radio
ny=1, magnetic ny=3); larger ny uses ops/kalman.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..ops.kalman import (
    _chol_small_batched,
    _Li_from_chol_small_batched,
    _tri_solve_small_batched,
)

_LOG2PI = float(np.log(2.0 * np.pi))
_HIGHEST = jax.lax.Precision.HIGHEST


def _factor_projection(C, Wt):
    """CWt [N, ny, rw] = C Wt^T: the factor rows seen through C."""
    return jnp.einsum("pin,prn->pir", C, Wt, precision=_HIGHEST,
                      preferred_element_type=jnp.float32)


def gather_cp_reference(bidx, C, Wt, P_base):
    """Plain CP[b] = C[b] (P_base[bidx[b]] - Wt[b]^T Wt[b]) -> [N, ny, nl] f32.

    Materializes the gathered covariances; the factor correction is
    applied as (C Wt^T) Wt so Wt^T Wt is never formed."""
    P = jnp.take(P_base, bidx, axis=0)
    CP = jnp.einsum("pij,pjk->pik", C, P,
                    preferred_element_type=jnp.float32)
    corr = jnp.einsum("pir,prn->pin", _factor_projection(C, Wt), Wt,
                      preferred_element_type=jnp.float32)
    return CP - corr


_ROWS = 16   # rows of the smallest Triton dot operand; rows >= ny masked

# Tile shapes and Triton launch parameters. Each choice came from a
# 10-point (gather-CP) and 6-point (rebase) sweep on one H100 80GB HBM3
# at 400 W, at N_P=16384, nl=128, bf16 and at N_P=4096, nl=512, f32: no
# point was best at both shapes, and these were within 8% of the best at
# each. Wider tiles cap at the next power of two of nl (>= 16).
# gather-CP: a [64, 128] P_base tile per pipeline stage. In the sweep
# 8 warps gained 4% at nl=128 and lost 14% at nl=512; 4 stages or a
# 128-row K tile lost at both shapes.
_CP_BLOCK_K = 64
_CP_BLOCK_N = 128
_CP_WARPS = 4
_CP_STAGES = 3
# rebase: one [128, 128] output tile per program (a rank-rw dot, then
# one read and one write of the tile). 32- and 64-wide tiles lost at
# nl=128; 64 wide with 8 warps gained 4% at nl=512 only.
_REBASE_BLOCK = 128
_REBASE_WARPS = 4
_REBASE_STAGES = 2


def _gather_cp_kernel(bidx_ref, c_ref, cwt_ref, wt_ref, p_ref, out_ref, *,
                      ny, nl, rw, block_k, block_n):
    """One (particle, column tile) program: out[b, :, tile] over all rows.

    Loads its own ancestor index, then streams P_base[bidx[b]] in
    [block_k, block_n] tiles through a dot with the particle's C rows
    (padded to 16; the pipeline depth is the compiler's num_stages).
    Ragged nl and the factor rows beyond rw are masked."""
    b = pl.program_id(0)
    col0 = pl.program_id(1) * block_n
    col_ok = col0 + jnp.arange(block_n) < nl
    row_ok = jnp.arange(_ROWS) < ny
    src = bidx_ref[b]

    def body(kk, acc):
        k0 = kk * block_k
        k_ok = k0 + jnp.arange(block_k) < nl
        p = pltriton.load(
            p_ref.at[src, pl.ds(k0, block_k), pl.ds(col0, block_n)],
            mask=k_ok[:, None] & col_ok[None, :], other=0.0,
        )
        c = pltriton.load(
            c_ref.at[b, pl.ds(0, _ROWS), pl.ds(k0, block_k)],
            mask=row_ok[:, None] & k_ok[None, :], other=0.0,
        ).astype(p.dtype)
        return acc + pl.dot(c, p, allow_tf32=False)

    acc = jax.lax.fori_loop(0, pl.cdiv(nl, block_k), body,
                            jnp.zeros((_ROWS, block_n), jnp.float32))
    rw_pad = max(_ROWS, pl.next_power_of_2(rw))
    r_ok = jnp.arange(rw_pad) < rw
    cw = pltriton.load(cwt_ref.at[b, pl.ds(0, _ROWS), pl.ds(0, rw_pad)],
                       mask=row_ok[:, None] & r_ok[None, :], other=0.0)
    wt = pltriton.load(
        wt_ref.at[b, pl.ds(0, rw_pad), pl.ds(col0, block_n)],
        mask=r_ok[:, None] & col_ok[None, :], other=0.0,
    ).astype(jnp.float32)
    pltriton.store(out_ref.at[b, pl.ds(0, _ROWS), pl.ds(col0, block_n)],
                   acc - pl.dot(cw, wt, allow_tf32=False),
                   mask=row_ok[:, None] & col_ok[None, :])


def gather_cp_pallas(bidx, C, Wt, P_base, **call_kwargs):
    """CP through the Pallas/Triton kernel; same contract as
    :func:`gather_cp_reference`. ``call_kwargs`` are passed on to
    ``pl.pallas_call`` (the CPU tests run the kernel in the interpreter)."""
    n, ny, nl = C.shape
    rw = Wt.shape[1]
    block_n = min(_CP_BLOCK_N, max(16, pl.next_power_of_2(nl)))
    block_k = min(_CP_BLOCK_K, max(16, pl.next_power_of_2(nl)))
    kernel = functools.partial(_gather_cp_kernel, ny=ny, nl=nl, rw=rw,
                               block_k=block_k, block_n=block_n)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, ny, nl), jnp.float32),
        grid=(n, pl.cdiv(nl, block_n)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_CP_WARPS,
                                                num_stages=_CP_STAGES),
        name="gather_cp",
        **call_kwargs,
    )(bidx.astype(jnp.int32), C, _factor_projection(C, Wt), Wt, P_base)


def gather_cp(bidx, C, Wt, P_base):
    """CP [N, ny, nl] f32: the Triton kernel when lowered for CUDA, the
    plain version on the CPU; any other platform fails to lower."""
    return jax.lax.platform_dependent(
        bidx, C, Wt, P_base, cuda=gather_cp_pallas, cpu=gather_cp_reference,
    )


def kf_update_lowrank(bidx, C, xl_gathered, Wt_gathered, P_base, y, R,
                      jitter: float = 1e-3):
    """Factored dense KF update: covariance P = P_base - Wt^T Wt.

    bidx [N] int32 ancestor-composed base indices into P_base; C
    [N, ny, nl] Jacobians at the propagated particles (storage dtype);
    xl_gathered [N, nl]; Wt_gathered [N, rw, nl] accumulated factor rows
    (already resampled; zero rows are inactive and contribute nothing);
    P_base [N, nl, nl] the last rebased covariances (read-only between
    rebases).
    Returns (xl', Wnew [N, ny, nl] storage dtype, logw, retried) where
    Wnew = L^-1 C P are the step's whitened factor rows (Wnew^T Wnew is
    exactly the covariance downdate) to place into Wt — engines/rbpf.py
    does the placement. Same algebra as
    ops.kalman.kalman_update_dense_batched on the materialized P, up to
    fp ordering; ny <= 3.
    """
    n, ny, nl = C.shape
    if ny > 3:
        raise ValueError("lowrank KF update supports ny <= 3")
    CP = gather_cp(bidx.astype(jnp.int32), C, Wt_gathered, P_base)
    S = jnp.einsum("pij,pkj->pik", CP, C,
                   preferred_element_type=jnp.float32) \
        + jnp.asarray(R, jnp.float32)[None]
    L, bad = _chol_small_batched(S, jitter)
    e = y[None, :].astype(jnp.float32) \
        - jnp.einsum("pij,pj->pi", C, xl_gathered,
                     preferred_element_type=jnp.float32)
    z = _tri_solve_small_batched(L, e)             # [N, ny]
    logw = (
        -0.5 * jnp.sum(z * z, axis=-1)
        - jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * ny * _LOG2PI
    )
    Li = _Li_from_chol_small_batched(L)
    # ONE combined gain product: stack the state-gain row z'L^-1 on top
    # of L^-1 so xl' and the new factor rows come from a single pass
    # over CP (one read of the [N, ny, nl] f32 tensor instead of two)
    zLi = jnp.einsum("pi,pij->pj", z, Li)
    G = jnp.concatenate([zLi[:, None, :], Li], axis=1)   # [N, 1+ny, ny]
    out = jnp.einsum("pij,pjk->pik", G, CP,
                     preferred_element_type=jnp.float32)
    xl_new = xl_gathered.astype(jnp.float32) + out[:, 0]
    Wnew = out[:, 1:].astype(Wt_gathered.dtype)
    return xl_new, Wnew, logw, bad


def rebase_reference(bidx, Wt, P_base):
    """Plain P' [N, nl, nl] = P_base[bidx] - Wt^T Wt (storage dtype)."""
    dd = jnp.einsum("pri,prj->pij", Wt, Wt,
                    preferred_element_type=jnp.float32)
    return jnp.take(P_base, bidx, axis=0) - dd.astype(P_base.dtype)


def _rebase_kernel(bidx_ref, wt_ref, p_ref, out_ref, *, nl, rw, block):
    """One (particle, row tile, column tile) program of the rebase: the
    ancestor's P_base tile minus the factor's rank-rw product, written
    once in the storage dtype."""
    b = pl.program_id(0)
    r0 = pl.program_id(1) * block
    c0 = pl.program_id(2) * block
    r_ok = r0 + jnp.arange(block) < nl
    c_ok = c0 + jnp.arange(block) < nl
    rw_pad = max(_ROWS, pl.next_power_of_2(rw))
    w_ok = jnp.arange(rw_pad) < rw
    wi = pltriton.load(wt_ref.at[b, pl.ds(0, rw_pad), pl.ds(r0, block)],
                       mask=w_ok[:, None] & r_ok[None, :], other=0.0)
    wj = pltriton.load(wt_ref.at[b, pl.ds(0, rw_pad), pl.ds(c0, block)],
                       mask=w_ok[:, None] & c_ok[None, :], other=0.0)
    dd = pl.dot(wi, wj, trans_a=True, allow_tf32=False)
    tile = r_ok[:, None] & c_ok[None, :]
    p = pltriton.load(
        p_ref.at[bidx_ref[b], pl.ds(r0, block), pl.ds(c0, block)],
        mask=tile, other=0.0,
    )
    pltriton.store(out_ref.at[b, pl.ds(r0, block), pl.ds(c0, block)],
                   (p.astype(jnp.float32) - dd).astype(out_ref.dtype),
                   mask=tile)


def rebase_pallas(bidx, Wt, P_base, **call_kwargs):
    """The rebase through a Pallas/Triton kernel (same contract as
    :func:`rebase_reference`, one rounding to the storage dtype)."""
    n, rw, nl = Wt.shape
    block = min(_REBASE_BLOCK, max(16, pl.next_power_of_2(nl)))
    nb = pl.cdiv(nl, block)
    return pl.pallas_call(
        functools.partial(_rebase_kernel, nl=nl, rw=rw, block=block),
        out_shape=jax.ShapeDtypeStruct((n, nl, nl), P_base.dtype),
        grid=(n, nb, nb),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_REBASE_WARPS,
                                                num_stages=_REBASE_STAGES),
        name="rebase",
        **call_kwargs,
    )(bidx.astype(jnp.int32), Wt, P_base)


def kf_rebase(bidx, Wt, P_base):
    """P' [N, nl, nl] = P_base[bidx] - Wt^T Wt (storage dtype): the
    once-per-period materialization. The Triton kernel when lowered for
    CUDA, the plain version on the CPU."""
    return jax.lax.platform_dependent(
        bidx, Wt, P_base, cuda=rebase_pallas, cpu=rebase_reference,
    )
