"""What the readers share."""

from __future__ import annotations

from typing import Optional


def device_ms(ctx, name: str) -> Optional[float]:
    """Device ms a step of the work launched inside the program's range
    `name`; None where the stretch holds none."""
    if not ctx.trace.get("steps"):
        return None
    v = ctx.trace["device_ms"].get(name)
    return v if v else None


def host_ms(ctx, name: str) -> Optional[float]:
    if not ctx.trace.get("steps"):
        return None
    v = ctx.trace["host_ms"].get(name)
    return v if v else None
