"""The reader of the program's ``train.replay`` span on a made-up trace:
nothing where the program has no such span (a program that replays no
graph, or names no replay), host milliseconds a step where it has."""

import pytest

from harness.cell import Cell, benchmark_file
from harness.profile import Trace

METRIC = "replay_ms.train"


def made_up_trace(spans):
    trace = Trace(window_s=1.0, steps=40, examples=5120.0,
                  flops=40 * 1.6e10, facts={})
    trace.span_s = dict(spans)
    return trace


def reader():
    cell = Cell(benchmark_file(), "compgcn-fb15k237.train")
    assert METRIC in {m["name"] for m in cell.per_layer}
    return cell.reader(METRIC)


def test_reader_finds_nothing_without_the_replay_span():
    # the spans of a program whose groups run eagerly
    trace = made_up_trace({"train.forward": 0.1, "train.backward": 0.2,
                           "train.upload": 0.01})
    assert reader().read(trace) is None


def test_reader_gives_host_ms_a_step():
    trace = made_up_trace({"train.forward": 0.1, "train.replay": 0.002})
    assert reader().read(trace) == pytest.approx(0.05)
    trace.steps = 0
    assert reader().read(trace) is None
