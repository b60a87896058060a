"""The benchmark of ``kge_tpu_torch`` on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<config>.yaml``) and traffic mix
(``portbench/mixes/<traffic>.yaml``); the mix's entry
(``portbench/entries/<entry>.py``) builds the program's job from the seed,
drives it through the steps the reference will follow, warms it up, and
runs the measured window. With ``--trace 0`` the result line holds the
cell's end-to-end metrics; with ``--trace 1`` the window (at most the
mix's ``trace_seconds``) runs under ``torch.profiler`` and the line holds
the per-layer metrics, each read by ``portbench/metrics/<metric>.py``.

After the window the program is freed and the plain reference
(``portbench/models/``) holds what the window's job produced; every
number compared is printed beside its limit, on standard error and under
``checks``, the last key of the result line. The run fails, and prints no
result, without a card, with fewer cards than the cell asks for, or when
a module of JAX or of the JAX package is loaded in this process after
set-up, after the window, after the check or before the line."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.append(ROOT)

# the program's caches stay in fixed folders of the checkout; the port's
# nvcc builds go to kge_tpu_torch/_build/ by its own rule
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(HERE, ".cache",
                                                     "inductor")
os.environ["USE_FLAX"] = "0"

from harness.cell import Cell, benchmark_file, phase  # noqa: E402
from harness.guard import forbidden_modules  # noqa: E402


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def guard():
    """Fail the run, before any result, when a module of JAX or of the JAX
    package is loaded in this process."""
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}")


def device_facts(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def measure(cell, seed: int, seconds: float, traced: bool, device: str,
            start: float = START) -> dict:
    """One run of ``cell``: set-up, the window, the reference's check.
    Returns the result line's fields (without ``device``) and the
    profiler's facts when traced."""
    import torch

    run = cell.entry().Run(cell, seed, device)
    setup_s = time.perf_counter() - start
    guard()
    facts = {}
    if traced:
        from torch.profiler import ProfilerActivity, profile
        from harness.profile import Trace, reduce

        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            window = run.window(min(seconds, float(cell.mix["trace_seconds"])),
                                traced=True)
        trace = reduce(prof, Trace(window["window_s"], window["steps"],
                                   window["examples"], window["flops"],
                                   window["facts"]))
        trace.cell = cell
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        facts = {"busy_s": trace.busy_s, "window_s": trace.window_s,
                 "breakdown": {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}}
    else:
        window = run.window(seconds)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                rate = window["examples"] / window["window_s"]
                metrics[m["name"]] = {"value": rate, "unit": m["unit"]}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        facts["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    guard()
    phase("window")
    numbers = run.check()
    phase("check")
    guard()
    for name, value, limit in numbers:
        if limit is None:
            print(f"portbench: reading {name} {value!r}", file=sys.stderr)
    checks = [c for c in numbers if c[2] is not None]
    failed = sum(1 for _, value, limit in checks if not value <= limit)
    return {"correct": failed == 0, "attempted": int(window["examples"]),
            "failed": failed,
            "metrics": metrics, "checks": checks, "facts": facts}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    print(f"portbench: phase process-start at {START:.3f} s", file=sys.stderr)
    phase("arguments")
    cell = Cell(benchmark_file(), args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.workload['name']} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} are here", 3)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    device = device_facts(torch, cell.chips)
    facts = out["facts"]
    device["memory_peak_bytes"] = facts.get("memory_peak_bytes",
                                            device["memory_peak_bytes"])
    if args.trace:
        device["busy_s"] = facts["busy_s"]
        device["window_s"] = facts["window_s"]
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in out["checks"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = facts["breakdown"]
    line["checks"] = checks
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    guard()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
