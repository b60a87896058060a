"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository. They run the harness on the host at small
sizes; the test marked ``cuda`` runs each cell at its own size on a
card."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

#: a graph small enough for the host
SMALL_GRAPH = {"graph": {"entities": 300, "relations": 12,
                         "splits": {"train": 3000, "valid": 200,
                                    "test": 200}}}
#: per cell, the mix's settings on the host: smaller batches
HOST_MIX = {
    "compgcn-fb15k237.train": {"program": {"train": {"batch_size": 16}}},
}


@pytest.fixture
def small_cell():
    """A cell of ``BENCHMARK.json`` on the small graph."""
    from harness.cell import Cell, benchmark_file

    def make(workload):
        return Cell(benchmark_file(), workload, config_override=SMALL_GRAPH,
                    mix_override=HOST_MIX[workload])
    return make
