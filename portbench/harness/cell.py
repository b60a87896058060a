"""A cell of ``BENCHMARK.json``: its configuration file
(``configs/<config>.yaml``), its traffic mix (``mixes/<traffic>.yaml``),
and the metrics it reports, all found by the names ``BENCHMARK.json``
gives. A later cell brings its own files and entries and edits none of
these."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, Optional

import yaml

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
#: the benchmark's fixed cache folders in the checkout (git-ignored):
#: graphs by seed and sizes, the program's config of a run, Triton's cache
CACHE = os.path.join(HERE, ".cache")


def phase(name: str):
    """Note on standard error when a phase of the run ended (seconds since
    the process's clock started), for the set-up's split in PERF.md."""
    import sys
    import time

    print(f"portbench: phase {name} at {time.perf_counter():.3f} s",
          file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    def __init__(self, benchmark: Dict, workload: str,
                 config_override: Optional[Dict] = None,
                 mix_override: Optional[Dict] = None):
        """``config_override`` and ``mix_override`` are merged over the
        files' settings (the tests' small graphs on the host)."""
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in benchmark["configs"]}
        entry = configs[self.workload["config"]]
        with open(os.path.join(ROOT, entry["file"])) as f:
            self.config = yaml.safe_load(f)
        if config_override:
            self.config = _merge(self.config, config_override)
        with open(os.path.join(HERE, "mixes",
                               self.workload["traffic"] + ".yaml")) as f:
            self.mix = yaml.safe_load(f)
        if mix_override:
            self.mix = _merge(self.mix, mix_override)
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in benchmark["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in benchmark["per_layer"]
                          if m["moves"] in reported
                          and workload in m.get("workloads", [workload])]
        self.model = load_module(
            os.path.join(HERE, "models", self.config["model"] + ".py"),
            "models." + self.config["model"])
        self.limits = self.config.get("limits", {}).get(self.mix["entry"], {})

    def entry(self):
        """The module of the mix's entry (``entries/<entry>.py``)."""
        return load_module(os.path.join(HERE, "entries",
                                        self.mix["entry"] + ".py"),
                           "entries." + self.mix["entry"])

    def reader(self, metric: str):
        """The reader of a per-layer metric (``metrics/<name>.py``)."""
        return load_module(os.path.join(HERE, "metrics", metric + ".py"),
                           "metrics." + metric.replace(".", "_"))

    def program_config(self, dataset_folder: str, seed: int, device: str,
                       options: Dict):
        """The program's ``Config``: the configuration file's ``program``
        settings over the synthetic graph, every seed derived from the
        run's, and the mix's ``options`` on top; written to a fixed file
        of the checkout for the program's loader."""
        from kge_tpu_torch import Config

        settings = _merge(self.config["program"], options)
        settings = _merge(settings, {
            "dataset": {"name": dataset_folder},
            "random_seed": {"default": seed % (2 ** 31 - 1), "numpy": -1,
                            "torch": -1, "python": -1},
            "job": {"device": device},
            "console": {"quiet": True},
        })
        os.makedirs(CACHE, exist_ok=True)
        path = os.path.join(CACHE, f"{self.name}.program.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(settings, f)
        config = Config()
        config.load(path, create=True)
        return config


def _merge(base: Dict, top: Dict) -> Dict:
    out = dict(base)
    for key, value in top.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def benchmark_file(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)

