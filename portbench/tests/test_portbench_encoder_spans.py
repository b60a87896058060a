"""The readers of the R-GNN encoder's program spans on a made-up trace:
nothing where the program has no such span (as a program without the
spans gives), device milliseconds a step where it has."""

import pytest

from harness.cell import Cell, benchmark_file
from harness.profile import Trace

READERS = {"encode_backward_ms.train": "train.encode.backward",
           "messages_ms.train": "train.encode.messages",
           "aggregate_ms.train": "train.encode.aggregate"}


def made_up_trace(cell):
    trace = Trace(window_s=1.0, steps=50, examples=6400.0,
                  flops=50 * 1.6e11, facts={})
    trace.cell = cell
    # the spans a program without the encoder's spans records
    trace.span_s = {"train.forward": 0.1, "train.backward": 0.2}
    trace.span_device_s = {"train.forward": 0.5, "train.backward": 0.6,
                           "portbench.encode": 0.35}
    return trace


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_finds_nothing_without_its_span(metric):
    cell = Cell(benchmark_file(), "compgcn-fb15k237.train")
    assert metric in {m["name"] for m in cell.per_layer}
    assert cell.reader(metric).read(made_up_trace(cell)) is None


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_gives_device_ms_a_step(metric):
    cell = Cell(benchmark_file(), "compgcn-fb15k237.train")
    trace = made_up_trace(cell)
    trace.span_device_s[READERS[metric]] = 0.2
    assert cell.reader(metric).read(trace) == pytest.approx(4.0)
    trace.steps = 0
    assert cell.reader(metric).read(trace) is None

