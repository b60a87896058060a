"""Synthetic knowledge graphs at a dataset's published sizes, kept in the
checkout by seed and sizes.

One graph a configuration is drawn from the configuration's fixed
``graph_seed`` by ``make_triples``, the generator of ``chip_smoke.py``'s
``write_dataset`` (distinct triples, entity and relation frequencies
Zipf-skewed with exponent 1, so some queries have hundreds of filtered
answers as in the real graphs), copied here so the benchmark does not
change when that script does. Each run's graph is that graph with its
entity and relation ids permuted by the run's seed: every seed gives the
program the same sizes, degrees and answer sets in another labelling, so
runs of different seeds do the same work."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Tuple

import numpy as np


def make_triples(sizes: Dict, seed: int) -> Dict[str, np.ndarray]:
    """``{split: int64 [n, 3]}`` of a graph with ``sizes`` (entities,
    relations, splits) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    E, R = sizes["entities"], sizes["relations"]
    total = sum(sizes["splits"].values())
    pe = 1.0 / np.arange(1, E + 1)
    pr = 1.0 / np.arange(1, R + 1)
    ent = rng.permutation(E)
    triples = np.zeros((0, 3), dtype=np.int64)
    while len(triples) < total:
        n = int(1.3 * total)
        drawn = np.stack([
            ent[rng.choice(E, n, p=pe / pe.sum())],
            rng.choice(R, n, p=pr / pr.sum()),
            ent[rng.choice(E, n, p=pe / pe.sum())],
        ], axis=1)
        triples = np.unique(np.concatenate([triples, drawn]), axis=0)
    triples = triples[rng.permutation(len(triples))[:total]]
    out, start = {}, 0
    for split, n in sizes["splits"].items():
        out[split] = triples[start:start + n]
        start += n
    return out


def _cached(folder: str):
    if os.path.isfile(os.path.join(folder, "done")):
        with np.load(os.path.join(folder, "triples.npz")) as saved:
            return {split: saved[split] for split in saved.files}
    return None


def _key(*parts) -> str:
    return hashlib.sha256(json.dumps(parts, sort_keys=True)
                          .encode()).hexdigest()[:16]


def dataset_folder(root: str, name: str, sizes: Dict, graph_seed: int,
                   seed: int) -> Tuple[str, Dict[str, np.ndarray]]:
    """The folder of the run's graph in the port's ``.del`` format under
    ``root`` (the graph of ``sizes`` and ``graph_seed``, its ids permuted
    by ``seed``), written if it is not there yet (fixed paths: a second
    run of the seed reads it), and the benchmark's own copy of its splits
    (``triples.npz`` beside the program's files)."""
    base = os.path.join(root, f"{name}-base-{_key(sizes, graph_seed)}")
    graph = _cached(base)
    if graph is None:
        graph = make_triples(sizes, graph_seed)
        os.makedirs(base, exist_ok=True)
        np.savez(os.path.join(base, "triples.npz"), **graph)
        with open(os.path.join(base, "done"), "w") as f:
            f.write("")
    folder = os.path.join(root, f"{name}-{_key(sizes, graph_seed, seed)}")
    splits = _cached(folder)
    if splits is not None:
        return folder, splits
    rng = np.random.default_rng(seed)
    ents = rng.permutation(sizes["entities"])
    rels = rng.permutation(sizes["relations"])
    splits = {split: np.stack([ents[t[:, 0]], rels[t[:, 1]], ents[t[:, 2]]],
                              axis=1) for split, t in graph.items()}
    os.makedirs(folder, exist_ok=True)
    np.savez(os.path.join(folder, "triples.npz"), **splits)
    for split, triples in splits.items():
        with open(os.path.join(folder, f"{split}.del"), "w") as f:
            f.write("\n".join(f"{a}\t{b}\t{c}" for a, b, c in
                              triples.tolist()))
            f.write("\n")
    for kind, count in (("entity_ids", sizes["entities"]),
                        ("relation_ids", sizes["relations"])):
        with open(os.path.join(folder, f"{kind}.del"), "w") as f:
            f.writelines(f"{i}\t/synthetic/{kind}/{i}\n" for i in range(count))
    with open(os.path.join(folder, "done"), "w") as f:
        f.write("")
    return folder, splits
