"""The harness finds every configuration, mix, entry, reference and reader
by the names ``BENCHMARK.json`` gives, and ``BENCHMARK.json`` keeps the
contract's shape; the operation and byte counts against hand counts."""

import math
import os
import re

import pytest

from harness.cell import HERE, ROOT, Cell, benchmark_file
from models import compgcn_conve

BENCH = benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = Cell(BENCH, workload)
    assert cell.entry().Run
    assert cell.model.build
    assert cell.per_layer, "every cell reports a per-layer metric"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for metric in cell.per_layer:
        assert callable(cell.reader(metric["name"]).read)
        assert metric["moves"] in names


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for path in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, path))
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(HERE, "mixes",
                                           w["traffic"] + ".yaml"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_fft_and_encoder_counts_by_hand():
    assert compgcn_conve.fft_flops(8) == pytest.approx(2.5 * 8 * 3)
    # 3 nodes, 2 relations (5 rows with the inverses and the self-loop's),
    # 4 edges, d_in 4 -> d_out 5: rfft gives 3 bins, ccorr keeps 2
    assert compgcn_conve.ccorr_bins(4) == 2
    assert compgcn_conve.ccorr_bins(200) == 51
    fft = 2.5 * 4 * 2
    tables = (3 + 5) * fft
    products = (4 + 3) * 8 * 2
    nodes = 3 * 3 * (fft + 2 * 4 * 5)
    relations = 2 * 5 * 4 * 5
    sums = 10 * 3 * 5
    want = tables + products + nodes + relations + sums
    assert want == 1162
    assert compgcn_conve.encoder_flops(3, 2, 4, 4, 5) == pytest.approx(want)


def test_conve_counts_by_hand():
    # h 2, w 4: a 4x4 input, 3x3 filter -> 2x2 maps of 3 channels, d 8
    conv = 2 * 5 * 3 * 2 * 2 * 9
    proj = 2 * 5 * 3 * 2 * 2 * 8
    assert compgcn_conve.conve_flops(5, 7, 2, 4, 3, 8) == pytest.approx(
        conv + proj + 2 * 5 * 8 * 7)


def test_train_step_counts_by_hand():
    config = {"graph": {"entities": 3, "relations": 2,
                        "splits": {"train": 2}}}
    # the encoder as above (4 edges); ConvE at B 5, h 2, w 4: 2x2 maps of
    # 32 channels, d 4, scores against 3 entities
    encoder = 1162
    conve = 2 * 5 * 32 * 2 * 2 * 9 + 2 * 5 * 32 * 2 * 2 * 4 + 2 * 5 * 4 * 3
    assert compgcn_conve.train_step_flops(
        config, 5, d=4, height=2, width=4) == pytest.approx(
            3 * (encoder + conve))


def test_cell_step_count_is_the_layers_least_work():
    """At FB15k-237's sizes a step counts 15.98 GFLOP, a tenth of the
    per-edge count (159.8) that a route of per-edge transforms would do."""
    cell = Cell(BENCH, "compgcn-fb15k237.train")
    flops = compgcn_conve.train_step_flops(cell.config, 128)
    assert flops == pytest.approx(15.978e9, rel=1e-4)


def test_readers_on_a_made_up_trace():
    """Per-layer readers on a made-up trace: a share of a peak is never
    0 where nothing was read, and never above 100 when the work fits the
    time; a reader whose span is absent returns nothing."""
    from harness.profile import Trace

    cell = Cell(BENCH, "compgcn-fb15k237.train")
    trace = Trace(window_s=1.0, steps=50, examples=6400.0,
                  flops=50 * 1.6e11, facts={})
    trace.cell = cell
    assert cell.reader("encode_ms.train").read(trace) is None
    trace.span_device_s = {"portbench.encode": 0.35}
    assert cell.reader("encode_ms.train").read(trace) == pytest.approx(7.0)
    trace.busy_s = 0.8
    assert cell.reader("device_idle_pct.train").read(trace) == \
        pytest.approx(20.0)
    assert 0 < cell.reader("mfu.train").read(trace) < 100
    trace.span_s = {"train.collate": 0.05, "train.forward": 0.1,
                    "train.backward": 0.2, "train.optimizer": 0.05,
                    "train.upload": 0.01}
    assert cell.reader("collate_ms.train").read(trace) == pytest.approx(1.0)
    assert cell.reader("launch_ms.train").read(trace) == pytest.approx(7.0)
    assert cell.reader("upload_ms.train").read(trace) == pytest.approx(0.2)
    assert math.isfinite(cell.reader("collate_ms.train").read(trace))
    trace.flops = 0.0
    assert cell.reader("mfu.train").read(trace) is None
