"""Host milliseconds a training step in the program's ``train.forward``,
``train.backward`` and ``train.optimizer`` spans: the eager enqueue and
autograd (about 0 where groups of steps replay as CUDA graphs)."""

from __future__ import annotations

SPANS = ('train.forward', 'train.backward', 'train.optimizer')


def read(trace):
    if not trace.steps:
        return None
    seconds = sum(trace.span_s.get(name, 0.0) for name in SPANS)
    return 1e3 * seconds / trace.steps
