"""The import guard: the benchmark measures ``kge_tpu_torch`` alone, so no
module of JAX or of the JAX package may be loaded in its process. Names
are compared by their top-level part (before the first dot) as a whole:
``kge_tpu_torch`` is not ``kge_tpu``."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "optax", "flax", "kge_tpu"})


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
