"""rbslam_tpu — Rao-Blackwellized particle SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference MATLAB implementation of Kok, Solin & Schön (2024),
"Rao-Blackwellized Particle Smoothing for Simultaneous Localization and
Mapping" (manonkok/Rao-Blackwellized-SLAM-smoothing) — redesigned for
an accelerator (one NVIDIA GPU):

- `lax.scan` over the time recursion, `vmap` over the particle ensemble
  (replacing the reference's per-particle MATLAB for-loops,
  src/particleFilter.m:104-204),
- log-domain weights + systematic/multinomial resampling with explicit
  PRNG keys (replacing noise drawn inside model closures),
- ancestor-index bookkeeping with one post-scan trajectory
  reconstruction (replacing the O(T^2 N_P) in-loop history shuffle at
  src/particleFilter.m:117-118),
- batched per-particle Kalman/information-form updates as large batched
  matmuls, shardable over a (particle, map) device mesh.

Subpackages
-----------
math      quaternion/Lie algebra, PSD-safe Cholesky, log-sum-exp, Procrustes
basis     Laplacian eigenbasis (Hilbert-space GP), spectral densities
gp        batch reduced-rank GP regression + ML-II hyperparameters
data      trajectory generators, GP field simulators, dataset loaders
models    state-space models (radio2D, mag3D, pinhole2D, terrain-nav)
engines   RBPF filter, RBPS (CPF-AS) smoother, information-form smoother,
          localization PF, dense EKF baseline
ops       resampling, masked Kalman updates
parallel  device-mesh sharding of the particle ensemble
metrics   Procrustes-aligned RMSE/ATE, ESS, throughput counters
workloads the four reference example workloads as runnable configs
"""

__version__ = "0.1.0"
