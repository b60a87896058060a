"""Dataset indexes as flat numpy CSR structures (the port's own copy of
``kge_tpu/indexing.py``; ``get_all_coords`` gives identical arrays).

Capability parity with the reference indexing layer (reference:
kge/indexing.py), re-designed for a static-shape compiler: every index is a
set of dense numpy arrays (sorted keys + offsets + values) so that label
lookups become vectorized searchsorted/gather operations instead of the
reference's numba typed-dict loops. The arrays can be shipped to the device
as-is when an index is needed inside a compiled step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# slot constants
S, P, O = 0, 1, 2
SLOT_STR = ["s", "p", "o"]


class KvsAllIndex:
    """Maps key pairs (e.g. (s,p)) to all values of the remaining slot.

    Layout (CSR over sorted unique keys; reference equivalent:
    kge/indexing.py:7-191):

    - ``keys``: [K, 2] int32, unique key pairs in lexicographic order
    - ``offsets``: [K+1] int64 prefix offsets into ``values``
    - ``values``: [nnz] int32, answers grouped by key (ascending per group)

    Lookup encodes a pair into a single int64 and binary-searches the
    encoded sorted key vector.
    """

    def __init__(self, triples: np.ndarray, key_cols: List[int], value_col: int):
        self.key_cols = key_cols
        self.value_col = value_col
        triples = np.asarray(triples)
        keys = triples[:, key_cols].astype(np.int64)
        vals = triples[:, value_col].astype(np.int32)
        # stable lexicographic sort by (key1, key2, value)
        order = np.lexsort((vals, keys[:, 1], keys[:, 0]))
        keys = keys[order]
        vals = vals[order]
        if len(keys):
            new_group = np.empty(len(keys), dtype=bool)
            new_group[0] = True
            new_group[1:] = np.any(keys[1:] != keys[:-1], axis=1)
            group_starts = np.flatnonzero(new_group)
            self.keys = keys[group_starts].astype(np.int32)
            self.offsets = np.empty(len(group_starts) + 1, dtype=np.int64)
            self.offsets[:-1] = group_starts
            self.offsets[-1] = len(keys)
        else:
            self.keys = np.zeros((0, 2), dtype=np.int32)
            self.offsets = np.zeros(1, dtype=np.int64)
        self.values = vals
        # encoded keys for binary search
        self._stride = int(keys[:, 1].max()) + 1 if len(keys) else 1
        self._encoded = (
            self.keys[:, 0].astype(np.int64) * self._stride
            + self.keys[:, 1].astype(np.int64)
        )
        self._default = np.zeros(0, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.keys)

    def __getstate__(self):
        return {
            "key_cols": self.key_cols,
            "value_col": self.value_col,
            "keys": self.keys,
            "offsets": self.offsets,
            "values": self.values,
            "_stride": self._stride,
            "_encoded": self._encoded,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._default = np.zeros(0, dtype=np.int32)

    def _positions(self, pairs: np.ndarray) -> np.ndarray:
        """Return index into ``keys`` for each pair; -1 when absent."""
        pairs = np.asarray(pairs, dtype=np.int64)
        if len(self._encoded) == 0:  # empty split: nothing is present
            return np.full(len(pairs), -1, dtype=np.int64)
        enc = pairs[:, 0] * self._stride + pairs[:, 1]
        pos = np.searchsorted(self._encoded, enc)
        pos_clip = np.minimum(pos, len(self._encoded) - 1)
        found = self._encoded[pos_clip] == enc
        # out-of-stride pairs can never be present
        found &= (pairs[:, 1] < self._stride) & (pairs[:, 1] >= 0)
        return np.where(found, pos_clip, -1)

    def get(self, pair: Tuple[int, int]) -> np.ndarray:
        pos = self._positions(np.asarray([pair]))[0]
        if pos < 0:
            return self._default
        return self.values[self.offsets[pos] : self.offsets[pos + 1]]

    def get_all_coords(self, pairs: np.ndarray, return_counts: bool = False):
        """Batched lookup returning COO coordinates.

        For a [B, 2] array of key pairs, returns (rows, values): for every
        answer of pair i, one entry with rows==i. Vectorized equivalent of
        the reference's numba ``get_all`` (kge/indexing.py:111-168).
        With ``return_counts``, also returns the [B] per-pair answer
        counts (computed internally anyway; saves callers a second
        key-position pass).
        """
        pos = self._positions(pairs)
        present = pos >= 0
        starts = np.where(present, self.offsets[np.maximum(pos, 0)], 0)
        # clip the end lookup: an index over an EMPTY split has
        # offsets == [0], and the unconditional +1 inside np.where
        # would raise before the mask applies
        end_pos = np.minimum(np.maximum(pos, 0) + 1, len(self.offsets) - 1)
        ends = np.where(present, self.offsets[end_pos], 0)
        counts = (ends - starts).astype(np.int64)
        total = int(counts.sum())
        rows = np.repeat(np.arange(len(pairs), dtype=np.int64), counts)
        if total == 0:
            flat = np.zeros(0, dtype=np.int32)
        else:
            # gather the contiguous ranges in one shot: element j of row
            # i lives at starts[i] + j (a per-batch python loop over
            # slices was the hottest line of the KvsAll collate)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            flat = self.values[np.repeat(starts, counts) + within]
        if return_counts:
            return rows, flat, counts
        return rows, flat

    def counts_for(self, pairs: np.ndarray) -> np.ndarray:
        pos = self._positions(pairs)
        present = pos >= 0
        starts = self.offsets[np.maximum(pos, 0)]
        end_pos = np.minimum(np.maximum(pos, 0) + 1, len(self.offsets) - 1)
        ends = self.offsets[end_pos]
        return np.where(present, ends - starts, 0)

    def items(self):
        for i in range(len(self.keys)):
            yield (
                (int(self.keys[i, 0]), int(self.keys[i, 1])),
                self.values[self.offsets[i] : self.offsets[i + 1]],
            )


# ---------------------------------------------------------- index construction

_KEY_SPECS = {
    "sp": ([S, P], O, "o"),
    "po": ([P, O], S, "s"),
    "so": ([S, O], P, "p"),
}


def index_KvsAll(dataset, split: str, key: str) -> KvsAllIndex:
    key_cols, value_col, value = _KEY_SPECS[key]
    name = f"{split}_{key}_to_{value}"
    if name not in dataset._indexes:
        dataset._indexes[name] = KvsAllIndex(dataset.split(split), key_cols, value_col)
        dataset.config.log(
            f"{len(dataset._indexes[name])} distinct {key} pairs in {split}",
            prefix="  ",
        )
    return dataset._indexes[name]


def index_relation_types(dataset) -> List[str]:
    """Classify relations as 1-1 / 1-N / M-1 / M-N (Bordes et al., NIPS'13).

    A relation is "M" on the subject side when the mean number of subjects
    per (p,o) pair exceeds 1.5, and "N" on the object side when the mean
    number of objects per (s,p) pair exceeds 1.5 (reference:
    kge/indexing.py:235-272).
    """
    if "relation_types" not in dataset._indexes:
        num_r = dataset.num_relations()
        sp_index = dataset.index("train_sp_to_o")
        po_index = dataset.index("train_po_to_s")
        # mean answers per key, grouped by relation
        o_counts = np.zeros(num_r)
        o_keys = np.zeros(num_r)
        counts = (sp_index.offsets[1:] - sp_index.offsets[:-1]).astype(np.float64)
        np.add.at(o_counts, sp_index.keys[:, 1], counts)
        np.add.at(o_keys, sp_index.keys[:, 1], 1.0)
        s_counts = np.zeros(num_r)
        s_keys = np.zeros(num_r)
        counts = (po_index.offsets[1:] - po_index.offsets[:-1]).astype(np.float64)
        np.add.at(s_counts, po_index.keys[:, 0], counts)
        np.add.at(s_keys, po_index.keys[:, 0], 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            is_m = (s_counts / s_keys) > 1.5
            is_n = (o_counts / o_keys) > 1.5
        dataset._indexes["relation_types"] = [
            f"{'M' if is_m[i] else '1'}-{'N' if is_n[i] else '1'}"
            for i in range(num_r)
        ]
    return dataset._indexes["relation_types"]


def index_relations_per_type(dataset) -> Dict[str, set]:
    if "relations_per_type" not in dataset._indexes:
        result: Dict[str, set] = {}
        for i, t in enumerate(dataset.index("relation_types")):
            result.setdefault(t, set()).add(i)
        dataset._indexes["relations_per_type"] = result
    for t, rels in dataset._indexes["relations_per_type"].items():
        dataset.config.log(f"{len(rels)} relations of type {t}", prefix="  ")
    return dataset._indexes["relations_per_type"]


def index_frequency_percentiles(dataset) -> Dict[str, Dict[str, set]]:
    """Quartiles of entity/relation ids ordered by train-split frequency.

    Returns {"subject"/"relation"/"object": {"25%"/"50%"/"75%"/"top": set}}
    (reference: kge/indexing.py:293-356).
    """
    if "frequency_percentiles" not in dataset._indexes:
        train = dataset.split("train")
        result: Dict[str, Dict[str, set]] = {}
        for arg, col, num in [
            ("subject", S, dataset.num_entities()),
            ("relation", P, dataset.num_relations()),
            ("object", O, dataset.num_entities()),
        ]:
            freq = np.bincount(train[:, col], minlength=num)
            order = np.argsort(freq, kind="stable")
            result[arg] = {}
            for perc, (lo, hi) in [
                ("25%", (0.0, 0.25)),
                ("50%", (0.25, 0.5)),
                ("75%", (0.5, 0.75)),
                ("top", (0.75, 1.0)),
            ]:
                result[arg][perc] = set(order[int(lo * num) : int(hi * num)].tolist())
        dataset._indexes["frequency_percentiles"] = result
    return dataset._indexes["frequency_percentiles"]


class IndexWrapper:
    """Named, pickle-friendly thunk around an index function."""

    def __init__(self, fun, **kwargs):
        self.fun = fun
        self.kwargs = kwargs

    def __call__(self, dataset, **kwargs):
        self.fun(dataset, **self.kwargs)


def _invert_ids(dataset, obj: str):
    name = f"{obj}_id_to_index"
    if name not in dataset._indexes:
        # as_list: dense-index order, so the inversion maps EXTERNAL id
        # string -> dense index (enumerating the raw dict would build an
        # identity int->int map)
        ids = dataset.load_map(f"{obj}_ids", as_list=True)
        dataset._indexes[name] = {v: k for k, v in enumerate(ids)}
    dataset.config.log(
        f"Indexed {len(dataset._indexes[name])} {obj} ids", prefix="  "
    )


def create_default_index_functions(dataset):
    for split in dataset.files_of_type("triples"):
        for key, (key_cols, value_col, value) in _KEY_SPECS.items():
            dataset.index_functions[f"{split}_{key}_to_{value}"] = IndexWrapper(
                index_KvsAll, split=split, key=key
            )
    dataset.index_functions["relation_types"] = index_relation_types
    dataset.index_functions["relations_per_type"] = index_relations_per_type
    dataset.index_functions["frequency_percentiles"] = index_frequency_percentiles
    for obj in ["entity", "relation"]:
        dataset.index_functions[f"{obj}_id_to_index"] = IndexWrapper(
            _invert_ids, obj=obj
        )
