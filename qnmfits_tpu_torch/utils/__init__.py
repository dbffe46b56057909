"""Host utilities (port of qnmfits_tpu/utils): ``timed``, ``debug_nans``,
``sweep_progress`` and the block checkpointing ``resumable_sweep``."""

from .diagnostics import debug_nans, sweep_progress, timed  # noqa: F401
from .checkpoint import resumable_sweep  # noqa: F401
