"""Device milliseconds a training step of the kernels launched inside
``portbench.encode``, the span the benchmark puts around the R-GNN
encoder's entry (``KgeRgnnModel._encode``): the forward only. None
where the model has no such entry."""

from __future__ import annotations

SPAN = 'portbench.encode'


def read(trace):
    if not trace.steps or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / trace.steps
