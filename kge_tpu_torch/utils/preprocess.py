"""Dataset preprocessing: raw text triples -> indexed .del files +
dataset.yaml (the port's own copy of ``kge_tpu/utils/preprocess.py``,
which writes the same files; reference: data/preprocess/util.py).

    python -m kge_tpu_torch.utils.preprocess <folder> [--order_sop]
        [--wn11] [--seed N]

Vectorized re-design: splits load as numpy object arrays, id maps are
assigned densely in first-occurrence order across splits (train first),
and the derived splits are boolean masks:

- ``train_sample``: random subset of train, size = |valid|
- ``valid_without_unseen`` / ``test_without_unseen``: rows whose
  entities AND relations all appear in train
- labeled splits (e.g. WN11): positive/negative label column selects
  rows (``*_negatives`` files)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import yaml


@dataclass
class RawSplit:
    """One raw input file: tab-separated triples, optional label column."""

    file: str
    key: str                       # dataset.yaml key of the main split
    collect: bool = False          # entities/relations count as "seen"
    field_map: Dict[str, int] = None
    derived_sample_key: Optional[str] = None
    derived_filtered_key: Optional[str] = None
    label_field: Optional[int] = None
    positive_key: Optional[str] = None
    negative_key: Optional[str] = None
    # filled during processing
    rows: List[List[str]] = field(default_factory=list)


def _read_rows(folder: str, raw: RawSplit) -> List[List[str]]:
    with open(os.path.join(folder, raw.file), "r", encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def _write_del(folder: str, name: str, triples: np.ndarray) -> int:
    with open(os.path.join(folder, name), "w") as f:
        for s, p, o in triples:
            f.write(f"{s}\t{p}\t{o}\n")
    return len(triples)


def _write_map(folder: str, name: str, items: List[str]):
    with open(os.path.join(folder, name), "w") as f:
        for i, symbol in enumerate(items):
            f.write(f"{i}\t{symbol}\n")


def process_dataset(folder: str, raw_splits: List[RawSplit],
                    name: Optional[str] = None,
                    order_sop: bool = False,
                    seed: int = 0) -> Dict:
    """Assign dense ids, write all split/map files and dataset.yaml.

    Returns the dataset config dict. ``order_sop`` supports raw files in
    (subject, object, predicate) order.
    """
    field_map = {"S": 0, "P": 2 if order_sop else 1, "O": 1 if order_sop else 2}
    for raw in raw_splits:
        if raw.field_map is None:
            raw.field_map = dict(field_map)
        raw.rows = _read_rows(folder, raw)
        print(f"Found {len(raw.rows)} triples in {raw.file}")

    # dense ids in first-occurrence order across splits (train first)
    entity_ids: Dict[str, int] = {}
    relation_ids: Dict[str, int] = {}
    seen_entities: set = set()
    seen_relations: set = set()
    for raw in raw_splits:
        S, P, O = raw.field_map["S"], raw.field_map["P"], raw.field_map["O"]
        for row in raw.rows:
            for sym in (row[S], row[O]):
                if sym not in entity_ids:
                    entity_ids[sym] = len(entity_ids)
            if row[P] not in relation_ids:
                relation_ids[row[P]] = len(relation_ids)
            if raw.collect:
                seen_entities.add(row[S])
                seen_entities.add(row[O])
                seen_relations.add(row[P])
    print(f"{len(relation_ids)} distinct relations")
    print(f"{len(entity_ids)} distinct entities")

    config: Dict = {
        "name": name or os.path.basename(os.path.abspath(folder)),
        "num_entities": len(entity_ids),
        "num_relations": len(relation_ids),
    }
    _write_map(folder, "entity_ids.del", list(entity_ids.keys()))
    _write_map(folder, "relation_ids.del", list(relation_ids.keys()))
    for obj in ("entity", "relation"):
        config[f"files.{obj}_ids.filename"] = f"{obj}_ids.del"
        config[f"files.{obj}_ids.type"] = "map"

    rng = np.random.default_rng(seed)
    sample_size = None
    for raw in raw_splits:
        if raw.key == "valid":
            if raw.label_field is not None:
                # labeled splits (WN11): size by POSITIVES only, matching
                # the written valid split (the raw rows include an equal
                # number of negatives)
                sample_size = sum(
                    1 for r in raw.rows if int(r[raw.label_field]) == 1
                )
            else:
                sample_size = len(raw.rows)

    def add_file(key: str, filename: str, size: int, ftype: str = "triples",
                 **extra):
        config[f"files.{key}.filename"] = filename
        config[f"files.{key}.type"] = ftype
        config[f"files.{key}.size"] = size
        for k, v in extra.items():
            config[f"files.{key}.{k}"] = v

    for raw in raw_splits:
        S, P, O = raw.field_map["S"], raw.field_map["P"], raw.field_map["O"]
        indexed = np.array(
            [[entity_ids[r[S]], relation_ids[r[P]], entity_ids[r[O]]]
             for r in raw.rows],
            dtype=np.int64,
        ).reshape(-1, 3)
        seen_mask = np.array(
            [r[S] in seen_entities and r[O] in seen_entities
             and r[P] in seen_relations for r in raw.rows],
            dtype=bool,
        )
        if raw.label_field is not None:
            labels = np.array([int(r[raw.label_field]) for r in raw.rows])
            pos, neg = indexed[labels == 1], indexed[labels == -1]
            add_file(raw.positive_key, f"{raw.positive_key}.del",
                     _write_del(folder, f"{raw.positive_key}.del", pos))
            add_file(raw.negative_key, f"{raw.negative_key}.del",
                     _write_del(folder, f"{raw.negative_key}.del", neg))
            if raw.derived_filtered_key:
                fpos = indexed[(labels == 1) & seen_mask]
                add_file(
                    raw.derived_filtered_key,
                    f"{raw.derived_filtered_key}.del",
                    _write_del(folder, f"{raw.derived_filtered_key}.del", fpos),
                    split_type="valid" if "valid" in raw.key else "test",
                )
            continue
        add_file(raw.key, f"{raw.key}.del",
                 _write_del(folder, f"{raw.key}.del", indexed))
        if raw.derived_sample_key and sample_size:
            sample = indexed[
                rng.choice(len(indexed), min(sample_size, len(indexed)),
                           replace=False)
            ]
            add_file(raw.derived_sample_key, f"{raw.derived_sample_key}.del",
                     _write_del(folder, f"{raw.derived_sample_key}.del", sample))
        if raw.derived_filtered_key:
            filtered = indexed[seen_mask]
            add_file(raw.derived_filtered_key, f"{raw.derived_filtered_key}.del",
                     _write_del(folder, f"{raw.derived_filtered_key}.del",
                                filtered))

    with open(os.path.join(folder, "dataset.yaml"), "w") as f:
        f.write(yaml.dump({"dataset": config}))
    print(yaml.dump({"dataset": config}))
    return config


def preprocess_default(folder: str, order_sop: bool = False, seed: int = 0):
    """Standard 3-split pipeline (reference: preprocess_default.py)."""
    raw_splits = [
        RawSplit(file="train.txt", key="train", collect=True,
                 derived_sample_key="train_sample"),
        RawSplit(file="valid.txt", key="valid",
                 derived_filtered_key="valid_without_unseen"),
        RawSplit(file="test.txt", key="test",
                 derived_filtered_key="test_without_unseen"),
    ]
    return process_dataset(folder, raw_splits, order_sop=order_sop, seed=seed)


def preprocess_wn11(folder: str, seed: int = 0):
    """WN11-style pipeline with labeled (+1/-1) valid/test triples
    (reference: preprocess_wn11.py)."""
    raw_splits = [
        RawSplit(file="train.txt", key="train", collect=True,
                 derived_sample_key="train_sample"),
        RawSplit(file="valid.txt", key="valid", label_field=3,
                 positive_key="valid", negative_key="valid_negatives",
                 derived_filtered_key="valid_without_unseen"),
        RawSplit(file="test.txt", key="test", label_field=3,
                 positive_key="test", negative_key="test_negatives",
                 derived_filtered_key="test_without_unseen"),
    ]
    return process_dataset(folder, raw_splits, seed=seed)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        "python -m kge_tpu_torch.utils.preprocess",
        description="Index a folder of raw train.txt, valid.txt and "
                    "test.txt triples into .del files and dataset.yaml")
    parser.add_argument("folder")
    parser.add_argument("--order_sop", action="store_true",
                        help="raw triples are (subject, object, predicate)")
    parser.add_argument("--wn11", action="store_true",
                        help="labeled (+1/-1) valid and test triples")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.wn11:
        preprocess_wn11(args.folder, seed=args.seed)
    else:
        preprocess_default(args.folder, order_sop=args.order_sop,
                           seed=args.seed)
