"""The plain references against the program on the host at a small
size; the control (the reference on TF32-rounded operands) and planted
faults come out as not correct; the references import nothing of the
program or of JAX; a module of JAX loaded as late as the check fails the
run."""

import ast
import os
import sys
import types

import pytest
import torch

import run as harness_run
from harness.cell import HERE
from harness.faults import planted
from harness.guard import FORBIDDEN, forbidden_modules

CELLS = ["compgcn-fb15k237.train"]


def measure(cell, seed=2 ** 31 + 12345):
    return harness_run.measure(cell, seed, 0.5, False, "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(small_cell, workload):
    out = measure(small_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert not forbidden_modules()


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small_cell, workload):
    cell = small_cell(workload)
    run = cell.entry().Run(cell, 4242, "cpu")
    checks = run.check(control=True)
    assert any(limit is not None and value > limit
               for _, value, limit in checks), checks


FAULTS = [("compgcn-fb15k237.train", "unchanged_state"),
          ("compgcn-fb15k237.train", "half_batch"),
          ("compgcn-fb15k237.train", "reversed_step")]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f}" for w, f in FAULTS])
def test_planted_fault_is_not_correct(small_cell, workload, fault):
    with planted(fault):
        out = measure(small_cell(workload))
    assert not out["correct"], out["checks"]


def test_reversed_step_fails_on_the_signed_number(small_cell):
    """Going up the loss keeps every magnitude: the first step's signed
    gap is the number that reads it."""
    with planted("reversed_step"):
        out = measure(small_cell("compgcn-fb15k237.train"))
    failed = {name for name, value, limit in out["checks"]
              if not value <= limit}
    assert "first_step_gap" in failed, out["checks"]


def test_module_loaded_during_the_check_fails_the_run(small_cell,
                                                      monkeypatch, capsys):
    cell = small_cell("compgcn-fb15k237.train")
    entry = cell.entry()

    class Run(entry.Run):
        def check(self, control=False):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return super().check(control)

    monkeypatch.setattr(cell, "entry", lambda: types.SimpleNamespace(Run=Run))
    with pytest.raises(SystemExit) as exit_:
        measure(cell)
    assert exit_.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "jax" in out.err


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(HERE, "models")) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    found = set(_top_level_imports(os.path.join(HERE, "models", name)))
    assert not found & (FORBIDDEN | {"kge_tpu_torch"}), found
    assert found <= {"__future__", "math", "typing", "numpy", "torch",
                     "models"}, found


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["kge_tpu_torch", "kge_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["kge_tpu.models", "jax", "optax.tree"]) == [
        "jax", "kge_tpu.models", "optax.tree"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    """Each cell at its own size on a card, with a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from harness.cell import Cell, benchmark_file

    out = harness_run.measure(Cell(benchmark_file(), workload), 2 ** 31 + 7,
                              2.0, False, "cuda")
    assert out["correct"], out["checks"]
