"""The headline disturbance boxplot experiment (main.m:37-60) on the
factored-carry filter path: kf_kernel='lowrank' at m=509 (nl=512,
f32). The factored carry needs no
per-step symmetrization (structurally symmetric — RESULTS.md r5); the
smoother keeps its symmetrized f32 carry (accuracy-validated default).
Writes results/dense_mag_boxplot_lowrank.json.

Run: timeout 9000 python scripts/run_boxplot_lowrank.py
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rbslam_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from rbslam_tpu.workloads.dense_mag import DenseMagConfig, run_comparison

t0 = time.time()
cfg = DenseMagConfig(
    n_particles=100, n_sweeps=10, m_basis=509, m_sim=2000,
    smoother="info_form", ancestor_form="woodbury",
    kf_kernel="lowrank",
    cov_dtype="float32", symmetrize_cov=True,   # PF kernel ignores it
    seed=1,
)
out = run_comparison(cfg, disturbances=(0.0, 1.0, 5.0, 10.0), n_sim=20)
out["wall_s"] = time.time() - t0
out["kf_kernel"] = "lowrank"
with open(os.path.join(ROOT, "results/dense_mag_boxplot_lowrank.json"), "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out["rmse_by_disturbance"], indent=1))
print(f"wall: {out['wall_s']:.0f}s")
