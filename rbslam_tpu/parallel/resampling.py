"""Distributed resampling: explicit-collective ancestor selection on a
particle-sharded ensemble (SURVEY §2.4 "distributed resampling").

The reference resamples with per-particle inverse-CDF draws over the
full weight vector (tools/sample.m:30-33, src/particleFilter.m:104-113)
— an inherently global operation. The split used here:

- The *index* computation is cheap: weights are one float per particle,
  ~4 MB at the 1M-particle north star — negligible next to the particle
  states they select (per-particle covariances are ~64 KB each). We move
  weights, never states, to decide ancestry.
- The *state* exchange is the expensive part. Ancestor indices returned
  here are global; the caller's `jnp.take` on the sharded state tensors
  compiles to a partitioned gather in which only crossing particles
  (children whose ancestor lives on another shard) move between devices.

Two index schemes, both running inside `shard_map` with explicit
collectives (no GSPMD inference):

- ``replicated_cdf`` (default): all-gather the weight shards, one
  cumsum, every shard computes its own children's ancestors from the
  identical replicated CDF. Bitwise-identical to the single-device
  resampler — the sharding-equivalence gate.
- ``prefix``: per-shard weight sums are all-gathered (S floats,
  S = #shards); every shard holds the IDENTICAL segment-boundary array,
  so query ownership is decided by one ``searchsorted`` against it —
  exactly one owner per comb position by construction (independent
  per-shard interval tests are fp-inconsistent: a query could fall in a
  gap or an overlap between two shards' locally-computed bounds). The
  owner answers with its local inverse CDF in global coordinates, and
  the answers reach the shard that owns each *child* via one
  ``psum_scatter`` — each shard receives exactly its [N/S] slice (half
  the payload of the psum+slice it replaces). Index-for-index equal to
  the single-device resampler.
- ``local``: the O(1)-collective island form — zero resampling
  collectives beyond the weight normalization the filter already does.
  Each shard systematically resamples its n_local children from its OWN
  local particles and the children carry the shard's aggregate weight
  (logw = log W_o - log n_local) instead of the global uniform reset.
  Unbiased (E[#children of i] * child weight = w_i exactly), but NOT
  equal to single-device systematic draw-for-draw, and shard aggregate
  weights can degenerate over time — the engine surfaces ESS; pair with
  a periodic global resample when W_o skews. The exact modes move O(N)
  index payload because exact global systematic ancestry cannot be
  derived child-locally: the within-segment inverse CDF lives only on
  the owning shard. ``local`` is the crossing-particle-free scaling
  mode; ``prefix`` is the exact mode with minimal index routing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

_AXIS = "particles"


def _comb(key, n, scheme, dtype):
    """Global inverse-CDF query positions in [0, 1), sorted for
    systematic/stratified (systematic's sortedness is what makes the
    fused gather kernels near-streaming)."""
    if scheme == "systematic":
        u0 = jax.random.uniform(key, ())
        return (jnp.arange(n, dtype=dtype) + u0) / n
    if scheme == "stratified":
        us = jax.random.uniform(key, (n,))
        return (jnp.arange(n, dtype=dtype) + us) / n
    if scheme == "multinomial":
        return jax.random.uniform(key, (n,))
    raise ValueError(f"unknown resampling scheme {scheme!r}")


def sharded_resample_indices(key, w, mesh: Mesh, scheme: str = "systematic",
                             mode: str = "replicated_cdf"):
    """Global ancestor indices for a particle-sharded weight vector.

    w: [N] normalized weights, sharded over the mesh's ``particles``
    axis. Returns ai [N] int32 (global indices), sharded the same way.
    Every shard uses the same `key`, so the comb is globally consistent.
    """
    n = w.shape[0]
    n_shards = mesh.shape[_AXIS]
    spec = P(_AXIS) if w.ndim == 1 else None
    dtype = w.dtype

    if mode == "replicated_cdf":

        def inner(w_local):
            w_all = jax.lax.all_gather(w_local, _AXIS, tiled=True)  # [N]
            cdf = jnp.cumsum(w_all)
            cdf = cdf / cdf[-1]
            idx = jax.lax.axis_index(_AXIS)
            n_local = w_local.shape[0]
            u_all = _comb(key, n, scheme, dtype)
            u = jax.lax.dynamic_slice(u_all, (idx * n_local,), (n_local,))
            return jnp.clip(
                jnp.searchsorted(cdf, u, side="right"), 0, n - 1
            ).astype(jnp.int32)

    elif mode == "prefix":

        def inner(w_local):
            n_local = w_local.shape[0]
            idx = jax.lax.axis_index(_AXIS)
            local_sum = jnp.sum(w_local)
            sums = jax.lax.all_gather(local_sum, _AXIS)        # [S]
            total = jnp.sum(sums)
            # IDENTICAL boundary array on every shard (all_gather order
            # is deterministic) -> ownership by searchsorted is unique
            # by construction: no fp gaps/overlaps between shards'
            # independently-computed interval tests.
            bounds = jnp.cumsum(sums)                          # [S]
            excl = jnp.concatenate([jnp.zeros((1,), dtype), bounds[:-1]])
            off = jax.lax.dynamic_slice(excl, (idx,), (1,))[0]
            u = _comb(key, n, scheme, dtype) * total            # [N] global
            owner = jnp.clip(
                jnp.searchsorted(bounds, u, side="right"), 0, n_shards - 1
            )
            mine = owner == idx
            # within-segment inverse CDF in global coordinates
            cdf_seg = off + jnp.cumsum(w_local)
            local_ai = jnp.clip(
                jnp.searchsorted(cdf_seg, u, side="right"), 0, n_local - 1
            )
            ai_partial = jnp.where(
                mine, idx * n_local + local_ai, 0
            ).astype(jnp.int32)
            # exactly one shard answers each query; psum_scatter merges
            # AND delivers each shard its own [n_local] child slice —
            # half the payload of psum + dynamic_slice
            ai = jax.lax.psum_scatter(
                ai_partial, _AXIS, scatter_dimension=0, tiled=True
            )
            return jnp.clip(ai, 0, n - 1)

    else:
        raise ValueError(f"unknown distributed resampling mode {mode!r}")

    return jax.shard_map(
        inner, mesh=mesh, in_specs=(spec,), out_specs=spec,
        check_vma=False,
    )(w)


def sharded_resample_local(key, w, mesh: Mesh, scheme: str = "systematic"):
    """Island resampling: O(1) collective payload, zero crossing particles.

    Each shard draws its n_local children from its OWN local particles
    by a local inverse-CDF comb (per-shard key fold), and the children
    inherit the shard's aggregate weight: logw' = log W_o - log n_local.
    The subsequent ancestor gather is purely shard-local — no particle
    states ever cross shards, and no index collective runs at all.

    Unbiased: E[#children of particle i] * child weight
    = n_local (w_i / W_o) * (W_o / n_local) = w_i — each particle's
    posterior mass is exactly preserved in expectation (the island /
    RNA distributed-PF scheme; reference semantics per island are
    tools/sample.m:30-33). NOT draw-for-draw equal to single-device
    systematic resampling; shard aggregate weights W_o are carried in
    the children's log-weights instead of being equalized, so a shard
    whose region loses posterior mass decays — monitor ESS and trigger
    a global (``prefix``/``replicated_cdf``) resample when skewed.

    Returns (ai [N] int32 global indices, each shard's in its own
    range; logw_prev [N] the post-resample log-weights to accumulate
    from — replaces the global -log N uniform reset).
    """
    spec = P(_AXIS)
    dtype = w.dtype

    def inner(w_local):
        n_local = w_local.shape[0]
        idx = jax.lax.axis_index(_AXIS)
        W = jnp.sum(w_local)
        Wsafe = jnp.maximum(W, jnp.asarray(1e-38, dtype))
        u = _comb(jax.random.fold_in(key, idx), n_local, scheme, dtype)
        cdf = jnp.cumsum(w_local)
        local_ai = jnp.clip(
            jnp.searchsorted(cdf, u * Wsafe, side="right"), 0, n_local - 1
        )
        ai = (idx * n_local + local_ai).astype(jnp.int32)
        logw_prev = jnp.full(
            (n_local,), 0.0, dtype
        ) + (jnp.log(Wsafe) - jnp.log(n_local))
        return ai, logw_prev

    return jax.shard_map(
        inner, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec),
        check_vma=False,
    )(w)
