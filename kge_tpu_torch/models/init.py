"""Parameter initializers, config-dispatched by torch-style names
(counterpart of ``kge_tpu/models/init.py``; reference:
kge/model/kge_model.py:41-80): normal_, uniform_, xavier_normal_,
xavier_uniform_, kaiming_uniform_, kaiming_normal_, trunc_normal_,
orthogonal_, constant_, ones_, zeros_.

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


def _calculate_gain(nonlinearity: str, a: float) -> float:
    """torch.nn.init.calculate_gain for the names kaiming accepts;
    ``a`` (negative slope) only matters for leaky_relu."""
    if nonlinearity in (
        "linear", "identity", "sigmoid", "conv1d", "conv2d", "conv3d",
        "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
    ):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + a * a))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


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
    if name in ("kaiming_uniform_", "kaiming_uniform",
                "kaiming_normal_", "kaiming_normal"):
        fan_in, fan_out = _fans(shape)
        fan = fan_out if args.get("mode", "fan_in") == "fan_out" else fan_in
        gain = _calculate_gain(args.get("nonlinearity", "leaky_relu"),
                               float(args.get("a", 0.0)))
        if name.startswith("kaiming_uniform"):
            bound = gain * math.sqrt(3.0 / fan)
            return uniform(-bound, bound)
        return normal(gain / math.sqrt(fan))
    if name in ("trunc_normal_", "trunc_normal"):
        mean = float(args.get("mean", 0.0))
        std = float(args.get("std", 1.0))
        a, b = float(args.get("a", -2.0)), float(args.get("b", 2.0))
        # inverse-CDF draw within [a, b] (torch.nn.init.trunc_normal_)
        cdf = lambda x: 0.5 * (1.0 + math.erf((x - mean) / std
                                              / math.sqrt(2.0)))
        lo, hi = 2.0 * cdf(a) - 1.0, 2.0 * cdf(b) - 1.0
        t = torch.erfinv(uniform(lo, hi))
        return torch.clamp(mean + std * math.sqrt(2.0) * t, a, b)
    if name in ("orthogonal_", "orthogonal"):
        # torch.nn.init.orthogonal_: QR of a normal draw, signs fixed by
        # R's diagonal; rows orthonormal when fewer than columns
        rows = shape[0]
        cols = math.prod(shape) // rows
        flat = torch.randn((rows, cols), generator=generator, **opts)
        if rows < cols:
            flat = flat.T
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return float(args.get("gain", 1.0)) * q.reshape(shape)
    if name in ("constant_", "constant"):
        return torch.full(shape, float(args.get("val", 0.0)), **opts)
    if name in ("ones_", "ones"):
        return torch.ones(shape, **opts)
    if name in ("zeros_", "zeros"):
        return torch.zeros(shape, **opts)
    raise ValueError(f"unknown initializer {name!r}")


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
