"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer readers take (host seconds of each span, device seconds of the
kernels launched inside each span, device seconds and launches of each
kernel by name, the device's busy seconds) and to the breakdown of the
result line (the device operations that took most time, and the device's
idle gaps by the host span that was open)."""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

#: host spans the breakdown and the readers know: the program's
#: ``record_function`` names and the benchmark's own
SPAN_PREFIXES = ("train.", "entity_ranking.", "comm.", "portbench.")


class Trace:
    """What one traced window measured. ``steps``: training steps or
    ranking batches in it; ``examples``: training examples or ranking
    queries; ``flops``: the model's operations over the window, counted
    from shapes by the cell's model module; ``facts``: counts the window's
    driver adds (such as the mean number of live candidates a draw
    made)."""

    def __init__(self, window_s: float, steps: int, examples: int,
                 flops: float, facts: Dict):
        self.window_s = window_s
        self.steps = steps
        self.examples = examples
        self.flops = flops
        self.facts = facts
        self.span_s: Dict[str, float] = {}
        self.span_device_s: Dict[str, float] = {}
        self.kernels: Dict[str, Tuple[float, int]] = {}
        self.busy_s = 0.0
        self.device_ops: List[List] = []
        self.idle_gaps: List[List] = []

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``part``."""
        seconds = launches = 0
        for name, (s, n) in self.kernels.items():
            if part in name:
                seconds += s
                launches += n
        return seconds, launches


def _device_time_us(event) -> float:
    value = getattr(event, "device_time_total", None)
    if value is None:
        value = event.cuda_time_total
    return float(value)


def reduce(prof, trace: Trace) -> Trace:
    """Fill ``trace`` from the finished profiler ``prof``."""
    from torch.autograd import DeviceType

    spans: List[Tuple[float, float, str]] = []
    ops: List[Tuple[float, float]] = []
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if name.startswith(SPAN_PREFIXES):
                trace.span_s[name] = trace.span_s.get(name, 0.0) + (
                    end - start) / 1e6
                trace.span_device_s[name] = trace.span_device_s.get(
                    name, 0.0) + _device_time_us(e) / 1e6
                spans.append((start, end, name))
        elif e.device_type == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIXES):
                continue  # the device side of a host span, no operation
            s, n = trace.kernels.get(name, (0.0, 0))
            trace.kernels[name] = (s + (end - start) / 1e6, n + 1)
            ops.append((start, end))
    ops.sort()
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for start, end in ops:
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    trace.busy_s = busy / 1e6
    top = sorted(trace.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    trace.device_ops = [[name[:64], s] for name, (s, _) in top]
    trace.idle_gaps = _gaps_by_span(gaps, spans)
    return trace


def _gaps_by_span(gaps, spans) -> List[List]:
    """The idle gaps' seconds summed by the innermost host span open at
    each gap's middle (``no_span`` where none is), longest first: a sweep
    over the middles in time order with the open spans in a heap by their
    start (a span that ended before one middle is closed for the
    later ones)."""
    spans.sort()
    out: Dict[str, float] = {}
    heap: List[Tuple[float, float, str]] = []
    i = 0
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        while i < len(spans) and spans[i][0] <= mid:
            start, end, name = spans[i]
            heapq.heappush(heap, (-start, end, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "no_span"
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:10]]
