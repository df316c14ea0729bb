"""What the two idle readers share: the program's record of the device's
idle between dispatches, ``gtopkssgd_tpu_torch.obs.tracing.idle``."""

from __future__ import annotations

import statistics
from typing import Optional


def median_ms(column: int) -> Optional[float]:
    """The median over the record's dispatches of column `column` (1:
    staging, 2: the tail), in ms a step; None where the program keeps no
    such record or it holds none (on the CPU)."""
    from gtopkssgd_tpu_torch.obs import tracing

    record = list(getattr(tracing, "idle", ()))
    if not record:
        return None
    return 1e3 * statistics.median(r[column] for r in record)
