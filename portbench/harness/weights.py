"""The benchmark's weights: drawn on the device from the run's seed, in a
few large calls, by the rules of the configuration file, and handed both
to the program (copied into its parameters) and to the reference.

A rule is ``{match: regex, init: normal | xavier_normal | uniform_fan_in
| ones | zeros, std: float, rows: entities | relations |
inverse_relations}``; the first rule whose regex searches the leaf's
name applies. ``rows`` draws only a table's first rows (the vocabulary:
the graph's entities, relations, or relations with their inverses) and
leaves the padding rows zero, as the program keeps them."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence

import torch


def _fans(shape: Sequence[int]):
    """torch's fans of a weight: [out, in, *kernel]."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    if len(shape) < 2:
        return shape[0], shape[0]
    return shape[1] * receptive, shape[0] * receptive


def _scale(rule: Dict, shape: Sequence[int]):
    """(mean, std) of the normal draw that stands for the rule's law."""
    init = rule["init"]
    if init == "ones":
        return 1.0, 0.0
    if init == "zeros":
        return 0.0, 0.0
    if init == "normal":
        return 0.0, float(rule["std"])
    fan_in, fan_out = _fans(shape)
    if init == "xavier_normal":
        return 0.0, math.sqrt(2.0 / (fan_in + fan_out))
    if init == "uniform_fan_in":
        # torch's default for Conv2d and Linear: U(-1/sqrt(fan_in), ..),
        # drawn as a normal of the same variance
        return 0.0, 1.0 / math.sqrt(3.0 * fan_in)
    raise ValueError(f"unknown init {init!r}")


def draw(shapes: Dict[str, Sequence[int]], rules: List[Dict], graph: Dict,
         seed: int, device) -> Dict[str, torch.Tensor]:
    """One float32 tensor a leaf of ``shapes``, all drawn in one normal
    call from a generator on ``device`` seeded with ``seed``."""
    vocab = {"entities": graph["entities"], "relations": graph["relations"],
             "inverse_relations": 2 * graph["relations"]}
    plan = []
    total = 0
    for name, shape in shapes.items():
        rule = next((r for r in rules if re.search(r["match"], name)), None)
        if rule is None:
            raise ValueError(f"no weight rule matches {name}")
        rows = vocab[rule["rows"]] if "rows" in rule else shape[0]
        drawn = (rows, *shape[1:]) if len(shape) > 1 else tuple(shape)
        mean, std = _scale(rule, drawn)
        n = math.prod(drawn)
        plan.append((name, shape, drawn, mean, std, total, n))
        total += n
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, shape, drawn, mean, std, offset, n in plan:
        leaf = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        leaf[:drawn[0]] = (z[offset:offset + n].view(drawn) * std + mean
                           if std else mean)
        out[name] = leaf
    return out
