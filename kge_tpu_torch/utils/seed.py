"""Deterministic seeding: per-consumer seeds derived from the default
seed + md5(consumer name) (reference: kge/util/seed.py:29-60)."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

from kge_tpu_torch.config import Config


def rng_seed_from_config(config: Config, name: str) -> int:
    """Seed for the named PRNG; derived from random_seed.default when the
    specific seed is -1. Returns -1 if seeding is disabled entirely."""
    try:
        seed = config.get(f"random_seed.{name}")
    except KeyError:
        seed = -1
    if seed < 0:
        default = config.get("random_seed.default")
        if default < 0:
            return -1
        digest = int(
            hashlib.md5(name.encode()).hexdigest(), 16
        ) % (2 ** 31)
        seed = (default + digest) % (2 ** 31)
    return seed


def torch_generator_from_config(config: Config,
                                device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``random_seed.torch``
    (nondeterministically when seeding is disabled)."""
    generator = torch.Generator(device=device)
    s = rng_seed_from_config(config, "torch")
    if s >= 0:
        generator.manual_seed(s)
    else:
        generator.seed()
    return generator


def seed_from_config(config: Config,
                     device: torch.device) -> torch.Generator:
    """Seed the python and numpy global PRNGs and return the job's torch
    generator on ``device``."""
    s = rng_seed_from_config(config, "python")
    if s >= 0:
        random.seed(s)
    s = rng_seed_from_config(config, "numpy")
    if s >= 0:
        np.random.seed(s)
    return torch_generator_from_config(config, device)
