"""Small host-side helpers: module file lookup, class registry, device
resolution, misc (the port's own copy of ``kge_tpu/utils/misc.py``).

Reproduces the reference's plugin mechanism (reference: kge/misc.py:13-42):
components are instantiated by class name, searched across the configured
module list, so user modules can contribute models/jobs/embedders by adding
themselves to the ``modules`` config list.
"""

from __future__ import annotations

import importlib
import os
import subprocess
from typing import List

import torch


def is_number(value, number_type) -> bool:
    try:
        number_type(value)
        return True
    except (ValueError, TypeError):
        return False


def module_base_dir(module_name: str) -> str:
    module = importlib.import_module(module_name)
    return os.path.abspath(os.path.dirname(module.__file__))


def kge_base_dir() -> str:
    """Root of the framework checkout (parent of the kge_tpu_torch package)."""
    return os.path.abspath(os.path.join(module_base_dir("kge_tpu_torch"), ".."))


def filename_in_module(module_or_names, filename: str) -> str:
    """Find ``filename`` inside one of the given modules' directories."""
    if not isinstance(module_or_names, list):
        module_or_names = [module_or_names]
    searched = []
    for entry in module_or_names:
        if isinstance(entry, str):
            directory = module_base_dir(entry)
        else:
            directory = os.path.dirname(entry.__file__)
        path = os.path.join(directory, filename)
        searched.append(directory)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{filename} not found in modules {searched}")


def init_from(class_name: str, modules: List[str], *args, **kwargs):
    """Instantiate ``class_name`` found in one of ``modules``."""
    for module_name in modules:
        module = importlib.import_module(module_name)
        if hasattr(module, class_name):
            return getattr(module, class_name)(*args, **kwargs)
    raise ValueError(
        f"class {class_name} not found in any of the modules {modules}"
    )


def get_git_revision_short_hash() -> str:
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=kge_base_dir(),
                stderr=subprocess.DEVNULL,
            )
            .decode()
            .strip()
        )
    except Exception:
        return ""


def round_to_points(round_points_to: List[int], to_round: int) -> int:
    """Round ``to_round`` to the nearest of the given points (reference:
    kge/misc.py:136)."""
    if len(round_points_to) == 0:
        return to_round
    return min(round_points_to, key=lambda x: abs(x - to_round))


def resolve_device(config) -> torch.device:
    """The torch device ``job.device`` names: ``auto`` and ``cuda`` mean
    the current CUDA device, ``cuda:N`` card N, ``cpu`` the host. A CUDA
    device that is not there raises; nothing falls back to the host."""
    name = config.get("job.device")
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto":
        name = "cuda"
    if not name.startswith("cuda"):
        raise ValueError(
            f"job.device {name!r} not supported (auto, cpu, cuda, cuda:N)"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"job.device {config.get('job.device')!r} needs a CUDA device and "
            "none is available; set job.device to cpu to run on the host"
        )
    device = torch.device(name)
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"job.device {name!r}: only {torch.cuda.device_count()} CUDA "
            "device(s) present"
        )
    return device


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (shape bucketing for ragged paddings:
    bounds the number of compiled program shapes)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
