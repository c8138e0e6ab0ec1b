"""Render the dense-mag disturbance boxplot figure
(examples/slam-dense-mag/main.m:80-123, boxplot-mag.png analog) from
results/dense_mag_boxplot.json.

Run: python scripts/plot_boxplot.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

d = json.load(open(os.path.join(ROOT, "results/dense_mag_boxplot.json")))
raw = d["raw"]
dists = sorted(raw.keys(), key=float)
methods = [("ekf", "EKF"), ("pf", "RBPF"), ("ps", "RBPS (info form)")]
colors = ["#d62728", "#1f77b4", "#2ca02c"]

fig, ax = plt.subplots(figsize=(8, 4.5))
width = 0.25
for j, (m, label) in enumerate(methods):
    data = [np.asarray(raw[o][m]) for o in dists]
    pos = [i + (j - 1) * width for i in range(len(dists))]
    bp = ax.boxplot(
        data, positions=pos, widths=width * 0.85, patch_artist=True,
        showfliers=True,
        flierprops=dict(marker=".", markersize=4, alpha=0.6),
    )
    for box in bp["boxes"]:
        box.set_facecolor(colors[j])
        box.set_alpha(0.6)
    for med in bp["medians"]:
        med.set_color("black")
    ax.plot([], [], color=colors[j], label=label, lw=6, alpha=0.6)

ax.set_xticks(range(len(dists)))
ax.set_xticklabels([f"{float(o):g}" for o in dists])
ax.set_xlabel("constant magnetic disturbance o [uT]")
ax.set_ylabel("position RMSE [m]")
# the reference's committed figure clamps its axis to [0, 0.3] m
# (main.m:80); keep the whole distribution visible but mark the bound
ax.axhline(0.3, color="gray", ls=":", lw=1)
ax.set_ylim(0, None)
ax.set_title(
    f"dense-mag: EKF vs RBPF vs RBPS under disturbance "
    f"(nSim={d['n_sim']}, N_P={d['n_particles']}, N_K={d['n_sweeps']}, "
    f"m={d['m_basis']})"
)
ax.legend(loc="upper left")
fig.tight_layout()
out = os.path.join(ROOT, "results/figures/boxplot-mag.png")
fig.savefig(out, dpi=130)
print("wrote", out)
