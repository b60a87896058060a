"""Host milliseconds a training step in the program's ``train.upload``
span (``_put_batch``, the stacked group, the resident epoch payload)."""

from __future__ import annotations

SPANS = ('train.upload',)


def read(trace):
    if not trace.steps:
        return None
    seconds = sum(trace.span_s.get(name, 0.0) for name in SPANS)
    return 1e3 * seconds / trace.steps
