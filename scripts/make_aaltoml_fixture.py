"""Generate the vendored AaltoML magnetic-data test fixture.

Writes a tiny synthetic dataset in the EXACT repository layout the
reference reads (examples/mag-localization-mapping/main.m:27-60):
``data/invensense/{i}-loc.csv / {i}-mag.csv / {i}-time.csv`` for
segments i = 1..9 — positions [n, 2], nav-frame magnetic field [n, 3]
(drawn from a curl-free scalar-potential GP + noise), timestamps [n].
Segment 3 is the held-out localization loop; segments {1, 2, 4} are
lawnmower mapping passes (the train/test split the workload applies,
run_localization.m semantics). Total size ~100 KB.

Run: python scripts/make_aaltoml_fixture.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from rbslam_tpu.data.fields import draw_scalar_potential_field

OUT = os.path.join(ROOT, "rbslam_tpu/data/assets/aaltoml_fixture/data/invensense")
EXTENT = 3.0
THETA = (10.0, 1.0, 25.0, 0.5)   # resolvable length scale, low noise
DT = 0.1

rng = np.random.default_rng(0)
segments = {}

# segments 1, 2, 4: lawnmower mapping passes (different line offsets)
for seg, off in ((1, 0.0), (2, 0.33), (4, 0.66)):
    xs = np.linspace(-EXTENT + off, EXTENT - 1 + off, 4)
    rows = []
    for i, x in enumerate(xs):
        ys = np.linspace(-EXTENT, EXTENT, 30)
        if i % 2:
            ys = ys[::-1]
        rows.append(np.stack([np.full_like(ys, x), ys], -1))
    segments[seg] = np.concatenate(rows, 0)

# segment 3: the held-out test loop (after the workload's [::50]
# downsample this gives a ~14-step localization run)
t = np.linspace(0, 2 * np.pi, 700)
segments[3] = np.stack(
    [0.55 * EXTENT * np.cos(t), 0.4 * EXTENT * np.sin(2 * t)], -1
)

# segments 5..9: short filler walks (present in the real dataset;
# unused by the workload's split but the loader must read them)
for seg in range(5, 10):
    start = rng.uniform(-1, 1, 2)
    steps = 0.05 * rng.standard_normal((50, 2))
    segments[seg] = start + np.cumsum(steps, 0)

all_pos = np.concatenate([segments[i] for i in range(1, 10)], 0)
pts3 = np.concatenate([all_pos, np.zeros((len(all_pos), 1))], -1)
LL = np.stack([[-EXTENT - 1, -EXTENT - 1, -1.0],
               [EXTENT + 1, EXTENT + 1, 1.0]])
draw = draw_scalar_potential_field(
    jax.random.PRNGKey(7), jnp.asarray(pts3, jnp.float32), 512, LL, THETA
)
y_all = np.asarray(draw.y)

os.makedirs(OUT, exist_ok=True)
o = 0
for seg in range(1, 10):
    n = len(segments[seg])
    np.savetxt(os.path.join(OUT, f"{seg}-loc.csv"), segments[seg],
               delimiter=",", fmt="%.5f")
    np.savetxt(os.path.join(OUT, f"{seg}-mag.csv"), y_all[o:o + n],
               delimiter=",", fmt="%.5f")
    np.savetxt(os.path.join(OUT, f"{seg}-time.csv"),
               DT * np.arange(n), delimiter=",", fmt="%.2f")
    o += n
print(f"wrote fixture to {OUT}: {o} samples over 9 segments")
