"""Hand-written kernels for the dense RBPF hot path (Pallas/Triton on CUDA)."""

from .kf_update import (
    gather_cp,
    gather_cp_reference,
    kf_rebase,
    kf_update_lowrank,
)

__all__ = [
    "gather_cp", "gather_cp_reference", "kf_rebase", "kf_update_lowrank",
]
