"""One port kernel's share of its roofline in the traced requests, for the
readers under metrics/ that report a single kernel's."""

from __future__ import annotations

from typing import Optional

from portbench import roofline


def roofline_pct(ctx, key: str) -> Optional[float]:
    """In %: ctx["bounds"][key], the least time of the kernel's work in the
    traced requests (roofline.py, from the cell's shapes), over the device
    time of its launches (roofline.kernel_of names them `key`). None with
    no trace, no bound or no launch."""
    tr, bounds = ctx["trace"], ctx["bounds"]
    if tr is None or key not in bounds:
        return None
    t = sum(e.end_ns - e.start_ns for e in tr.kernels() if roofline.kernel_of(e.name) == key)
    return 100.0 * bounds[key] / (t / 1e9) if t > 0 else None
