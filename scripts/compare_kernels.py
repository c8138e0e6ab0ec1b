"""Time the hand-written kernels on one GPU against their plain versions.

    python scripts/compare_kernels.py [--repeats 3]

Cells: the bench flagship (N_P=16384, m=125+3, bf16 carry) and the
reference-scale filter (N_P=4096, m=509+3, f32), T=192. In each cell:

- end to end: the dense-mag filter with ``kf_kernel="lowrank"`` (the
  factored carry, which runs the kernels) and with ``kf_kernel="xla"``
  (full covariance, plain XLA), each compiled once and timed in turns;
- alone, at the cell's shape: each Pallas/Triton kernel
  (``gather_cp_pallas``, ``rebase_pallas``) against its plain jnp
  reference (``gather_cp_reference``, ``rebase_reference``), and the
  batched measurement Jacobian.

One JSON line per measurement, each with the card's name and power
limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELLS = [  # (name, N_P, m, storage dtype)
    ("flagship", 16384, 125, "bfloat16"),
    ("refscale", 4096, 509, "float32"),
]
KF_KERNELS = ("lowrank", "xla")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _median_time(fn, *args, repeats=20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _compile_filter(cell, kf_kernel):
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.engines import RBPFConfig
    from rbslam_tpu.engines.rbpf import _run_rbpf
    from rbslam_tpu.workloads import dense_mag

    _, n_p, m, dtype = cell
    cfg = dense_mag.DenseMagConfig(n_particles=n_p, m_basis=m,
                                   cov_dtype=dtype, kf_kernel=kf_kernel)
    k_data = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[1]
    data, y, model, potential, _, k, Q, R = dense_mag.build_problem(
        cfg, k_data)
    rb = RBPFConfig(n_particles=n_p, resampling=cfg.resampling,
                    cov_dtype=dtype, kf_kernel=kf_kernel)

    def fn(key):   # the jitted engine body (run_rbpf adds eager checks)
        return _run_rbpf(key, model, data.dx, y, data.init_state,
                        jnp.zeros(potential.n_lin), jnp.diag(k), Q, R,
                        cfg.dt, rb)

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(jax.random.PRNGKey(0)).compile()
    return (compiled, time.perf_counter() - t0, int(y.shape[0]),
            (model, data))


def end_to_end(card, cell, repeats):
    import jax

    exe, compile_s = {}, {}
    for name in KF_KERNELS:
        exe[name], compile_s[name], T, built = _compile_filter(cell, name)
    order = (list(KF_KERNELS) + list(KF_KERNELS)[::-1]) * repeats
    times = {name: [] for name in KF_KERNELS}
    for i, name in enumerate(order):
        t0 = time.perf_counter()
        jax.block_until_ready(exe[name](jax.random.PRNGKey(i)))
        times[name].append(time.perf_counter() - t0)
    n_p = cell[1]
    out = {"what": "filter_end_to_end", "cell": cell[0], "N_P": n_p,
           "n_lin": cell[2] + 3, "dtype": cell[3], "T": T, "card": card,
           "compile_s": compile_s}
    for name, ts in times.items():
        med = float(np.median(ts))
        out[name] = {"runs_s": ts, "median_s": med,
                     "particle_steps_per_s": n_p * T / med,
                     "step_ms": 1e3 * med / T}
    print(json.dumps(out), flush=True)
    return out, built


def ops_alone(card, cell, step_ms, built):
    import jax
    import jax.numpy as jnp

    from rbslam_tpu.kernels.kf_update import (
        gather_cp_pallas,
        gather_cp_reference,
        rebase_pallas,
        rebase_reference,
    )

    name, n, m, dtype = cell
    model, data = built
    nl, ny, rw = m + 3, 3, 24
    dt = jnp.dtype(dtype)
    ks = jax.random.split(jax.random.PRNGKey(1), 5)
    P_base = jax.random.normal(ks[0], (n, nl, nl), dt)
    C = (0.3 * jax.random.normal(ks[1], (n, ny, nl))).astype(dt)
    Wt = (0.1 * jax.random.normal(ks[2], (n, rw, nl))).astype(dt)
    bidx = jnp.sort(jax.random.randint(ks[3], (n,), 0, n))
    cp_args, rebase_args = (bidx, C, Wt, P_base), (bidx, Wt, P_base)
    rows = {
        "gather_cp_kernel": _median_time(jax.jit(gather_cp_pallas),
                                         *cp_args),
        "gather_cp_plain": _median_time(jax.jit(gather_cp_reference),
                                        *cp_args),
        "rebase_kernel": _median_time(jax.jit(rebase_pallas), *rebase_args),
        "rebase_plain": _median_time(jax.jit(rebase_reference),
                                     *rebase_args),
    }
    xn = jnp.broadcast_to(data.init_state, (n, 7)) \
        + 0.1 * jax.random.normal(ks[4], (n, 7))
    rows["jacobian_vmap"] = _median_time(
        jax.jit(jax.vmap(model.meas_jacobian)), xn)
    p_bytes = n * nl * nl * dt.itemsize
    for op, s in rows.items():
        # bytes the op must move at least: P_base read once (gather-CP),
        # read + written once (rebase)
        floor = {"gather": p_bytes, "rebase": 2 * p_bytes}.get(
            op.split("_")[0])
        print(json.dumps({
            "what": "op_alone", "cell": name, "op": op, "median_ms": 1e3 * s,
            "share_of_lowrank_step": 1e3 * s / step_ms,
            "min_bytes_GB_per_s": floor / s / 1e9 if floor else None,
            "card": card}), flush=True)


def main():
    import jax

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    from rbslam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = _card()
    print(card, flush=True)
    for cell in CELLS:
        e2e, built = end_to_end(card, cell, args.repeats)
        ops_alone(card, cell, e2e["lowrank"]["step_ms"], built)


if __name__ == "__main__":
    main()
