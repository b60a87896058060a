"""Host milliseconds a training step in the program's ``train.replay``
span: the launch of a group of steps captured as a CUDA graph
(``graph.replay()``), over every step of the window, replayed or not.
Nothing where the program has no such span (it replays no graph, or
names no replay)."""

from __future__ import annotations

SPAN = 'train.replay'


def read(trace):
    if not trace.steps or SPAN not in trace.span_s:
        return None
    return 1e3 * trace.span_s[SPAN] / trace.steps
