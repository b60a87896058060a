"""Parameter initializers, config-dispatched by torch-style names
(counterpart of ``kge_tpu/models/init.py``; reference:
kge/model/kge_model.py:41-80). The names the lookup embedder documents
are ported: normal_, uniform_, xavier_normal_, xavier_uniform_.

Every draw comes from an explicit ``torch.Generator`` and is made on the
generator's device. The values differ from ``kge_tpu``'s (another PRNG);
tests carry weights across instead of comparing draws.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def initialize(generator: torch.Generator, shape, name: str,
               args: Dict) -> torch.Tensor:
    """Draw an initial float32 tensor of ``shape`` using the named scheme."""
    args = dict(args or {})
    args.pop("+++", None)
    opts = dict(dtype=torch.float32, device=generator.device)

    def normal(std: float, mean: float = 0.0) -> torch.Tensor:
        return mean + std * torch.randn(shape, generator=generator, **opts)

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=generator, **opts)

    if name in ("normal_", "normal"):
        return normal(float(args.get("std", 1.0)), float(args.get("mean", 0.0)))
    if name in ("uniform_", "uniform"):
        b = float(args.get("b", 1.0))
        # reference quirk (kge/model/kge_model.py:77-79): a missing lower
        # bound defaults to -b (symmetric), not torch's 0
        a = float(args["a"]) if "a" in args else -b
        return uniform(a, b)
    if name in ("xavier_normal_", "xavier_normal"):
        fan_in, fan_out = _fans(shape)
        return normal(float(args.get("gain", 1.0))
                      * math.sqrt(2.0 / (fan_in + fan_out)))
    if name in ("xavier_uniform_", "xavier_uniform"):
        fan_in, fan_out = _fans(shape)
        a = float(args.get("gain", 1.0)) * math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-a, a)
    raise ValueError(
        f"initializer {name!r} unknown or not yet ported (normal_, uniform_, "
        "xavier_normal_, xavier_uniform_)"
    )


def select_initialize_args(name: str, args: Dict) -> Dict:
    """If args has a subkey matching the initializer name, use that subtree
    (reference behavior for lookup_embedder.initialize_args)."""
    args = dict(args or {})
    args.pop("+++", None)
    if name in args and isinstance(args[name], dict):
        return args[name]
    if name.rstrip("_") in args and isinstance(args[name.rstrip("_")], dict):
        return args[name.rstrip("_")]
    # drop any other initializer-named subtrees
    return {k: v for k, v in args.items() if not isinstance(v, dict)}
