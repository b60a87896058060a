"""Device milliseconds a training step of the kernels launched inside
the program's ``train.encode.backward`` span: the R-GNN encoder's
backward (the gathers' ``index_add_``, the FFTs' and the GEMMs'
backward), on autograd's thread. None where the program has no such
span."""

from __future__ import annotations

SPAN = 'train.encode.backward'


def read(trace):
    if not trace.steps or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / trace.steps
