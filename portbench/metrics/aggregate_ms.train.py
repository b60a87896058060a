"""Device milliseconds a training step of the kernels launched inside
the program's ``train.encode.aggregate`` span: the R-GNN encoder's
reduce by node (the forward ``index_add_``, or the dense adjacency's
product), forward only. None where the program has no such span."""

from __future__ import annotations

SPAN = 'train.encode.aggregate'


def read(trace):
    if not trace.steps or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / trace.steps
