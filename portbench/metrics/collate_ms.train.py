"""Host milliseconds a training step in the program's ``train.collate``
span (the host batch: sampling, label coordinates, row payload); 0
where the window's epochs are device-resident and no step collates."""

from __future__ import annotations

SPANS = ('train.collate',)


def read(trace):
    if not trace.steps:
        return None
    seconds = sum(trace.span_s.get(name, 0.0) for name in SPANS)
    return 1e3 * seconds / trace.steps
