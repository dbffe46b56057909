"""Sweeps sharded over a mesh of torch.distributed ranks (port of
qnmfits_tpu/parallel)."""

from .mesh import (  # noqa: F401
    sharded_fit_core,
    sharded_t0_sweep,
    sweep_mesh,
)
