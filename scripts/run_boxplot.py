"""Reference-scale dense-mag disturbance comparison (the boxplot
experiment, examples/slam-dense-mag/main.m:37-60): nSim=20 MC runs per
disturbance o in {0, 1, 5, 10}, N_P=100, m=512+3, N_K=10 — EKF (batched)
vs RBPF vs info-form RBPS (Woodbury ancestor form). Writes
results/dense_mag_boxplot.json.

Run: timeout 9000 python scripts/run_boxplot.py
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
# symmetrize_cov=True is REQUIRED at reference scale: without the
# per-step re-symmetrization the f32 covariance asymmetry at nl=515
# accumulates over T=192 and the filter's weights go NaN (measured:
# 19-20/20 MC runs NaN at every disturbance level; with symmetrize the
# same seeds give finite RMSE ~0.24 m). The reference runs fp64 and
# never symmetrizes (src/particleFilter.m:198) — this is the documented
# f32 deviation (SURVEY §7.3#4).
cfg = DenseMagConfig(
    n_particles=100, n_sweeps=10, m_basis=512, m_sim=2000,
    ancestor_form="woodbury", symmetrize_cov=True,
)
out = run_comparison(cfg, disturbances=(0.0, 1.0, 5.0, 10.0), n_sim=20)
out["wall_s"] = time.time() - t0
with open(os.path.join(ROOT, "results/dense_mag_boxplot.json"), "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out["rmse_by_disturbance"], indent=1))
print("wall:", out["wall_s"], flush=True)
