"""Share of the traced training window in which no operation (kernel, copy
or memset) ran on the device, in %."""

from __future__ import annotations

def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
