"""The readings a cell's correctness limits are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault half_batch]

For each of ``--seeds`` a sound run of the program (with ``--fault``, a
run with that fault of ``harness/faults.py`` planted): the cell's set-up,
whose check steps the window's job goes on from, held against the
reference, as the benchmark's runs hold them. For each of ``--control-seeds`` the control: the reference on
operands rounded to TF32, the precision below the configuration's
float32, in the program's place. Prints one JSON line a seed, then the
largest sound reading and the smallest control reading of each number.
The benchmark's own runs do not run this."""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

from harness.cell import Cell, benchmark_file  # noqa: E402
from harness.faults import planted  # noqa: E402


def readings(cell, seeds, control: bool, device: str, fault: str = ""):
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            run = cell.entry().Run(cell, seed, device)
        checks = run.check(control=control)
        del run
        row = {"seed": seed, "control": control, "fault": fault,
               "seconds": time.perf_counter() - t0,
               **{name: value for name, value, _ in checks}}
        print(json.dumps(row), flush=True)
        out.append(checks)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", default="",
                        help="plant a fault of harness/faults.py in the "
                        "program for --seeds (no control then)")
    args = parser.parse_args(argv)
    cell = Cell(benchmark_file(), args.workload)
    import torch

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    sound = readings(cell, seeds, False, "cuda", args.fault)
    control = readings(cell, controls, True, "cuda")
    summary = {}
    for i, (name, value, limit) in enumerate(sound[0]):
        if not isinstance(value, (int, float)):
            continue
        summary[name] = {
            "lower": max(c[i][1] for c in sound),
            "upper": min(c[i][1] for c in control) if control else None,
            "limit": limit}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()
