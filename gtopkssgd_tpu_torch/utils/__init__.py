"""The trainer's lifecycle: JSONL metrics with a run manifest, checkpoints
that keep the error-feedback residual, and the host-batch prefetcher."""

from gtopkssgd_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    CheckpointMismatch,
)
from gtopkssgd_tpu_torch.utils.metrics import MetricsLogger
from gtopkssgd_tpu_torch.utils.prefetch import Prefetcher

__all__ = ["CheckpointManager", "CheckpointMismatch", "MetricsLogger",
           "Prefetcher"]
