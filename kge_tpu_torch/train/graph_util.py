"""Per-epoch graph subsampling (the port's own copy of
``kge_tpu/train/graph_util.py``; reference: kge/job/util.py:64-129).
Both samplers draw from the numpy generator they are given in
``kge_tpu``'s order, so an epoch's subgraph is the same in both
packages."""

from __future__ import annotations

import numpy as np


def sample_uniform(triples: np.ndarray, size: int, rng) -> np.ndarray:
    """Uniformly sample ``size`` edges from the training graph."""
    size = min(size, len(triples))
    idx = rng.choice(len(triples), size=size, replace=False)
    return triples[idx]


def sample_edge_neighbourhood(triples: np.ndarray, size: int, rng) -> np.ndarray:
    """Grow an edge sample that stays connected to already-picked
    entities (reference edge-neighbourhood sampler; same growth
    heuristic, vectorized).

    Frontier rounds: each round marks every unpicked edge incident to a
    seen entity eligible, draws uniformly from them up to the remaining
    budget, and folds the new endpoints into the seen set: O(|E|) numpy
    work a round, with the frontier typically growing geometrically."""
    size = min(size, len(triples))
    n = len(triples)
    chosen = np.zeros(n, dtype=bool)
    num_nodes = int(max(triples[:, 0].max(), triples[:, 2].max())) + 1
    seen = np.zeros(num_nodes, dtype=bool)
    first = int(rng.integers(n))
    chosen[first] = True
    seen[triples[first, 0]] = seen[triples[first, 2]] = True
    count = 1
    while count < size:
        eligible = np.flatnonzero(
            ~chosen & (seen[triples[:, 0]] | seen[triples[:, 2]])
        )
        if len(eligible) == 0:
            # disconnected remainder: restart from a fresh random edge
            remaining = np.flatnonzero(~chosen)
            i = int(rng.choice(remaining))
            chosen[i] = True
            seen[triples[i, 0]] = seen[triples[i, 2]] = True
            count += 1
            continue
        take = min(size - count, len(eligible))
        pick = rng.choice(eligible, size=take, replace=False)
        chosen[pick] = True
        seen[triples[pick, 0]] = True
        seen[triples[pick, 2]] = True
        count += take
    return triples[chosen]
