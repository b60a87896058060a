"""Dataset loading: triple splits, id maps, metadata, and lazy indexes
(the port's own copy of ``kge_tpu/dataset.py``).

Triples load as Nx3 int32 numpy arrays, entity/relation id and string
maps from tab-separated files, per-dataset overrides from
``dataset.yaml``, mtime-checked binary caches with atomic replacement,
and a lazy index registry (see :mod:`kge_tpu_torch.indexing`). Arrays
stay in host numpy; jobs move them to their device explicitly.

Cache files carry the port's own suffix (``<name>.torch.cache.pkl``):
``kge_tpu``'s caches pickle ``kge_tpu.indexing`` objects, and reading
one here would import the JAX package.
"""

from __future__ import annotations

import csv
import os
import pickle
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.indexing import create_default_index_functions
from kge_tpu_torch.utils.misc import kge_base_dir


class Dataset(Configurable):
    """A knowledge graph dataset: splits, id maps, metadata, indexes."""

    #: cache-format version; bump to invalidate all caches
    CACHE_VERSION = 1

    def __init__(self, config: Config, folder: Optional[str] = None):
        super().__init__(config, "dataset")
        self.folder = folder
        self._num_entities: Optional[int] = config.get("dataset.num_entities")
        if self._num_entities < 0:
            self._num_entities = None
        self._num_relations: Optional[int] = config.get("dataset.num_relations")
        if self._num_relations < 0:
            self._num_relations = None
        #: split name -> Nx3 int32 numpy array
        self._triples: Dict[str, np.ndarray] = {}
        #: map key -> list/dict payload (e.g. entity_ids)
        self._meta: Dict[str, Any] = {}
        #: lazily built indexes (see indexing.py)
        self._indexes: Dict[str, Any] = {}
        self.index_functions: Dict[str, Any] = {}
        create_default_index_functions(self)

    # ------------------------------------------------------------------ factory

    @staticmethod
    def create(config: Config, folder: Optional[str] = None,
               preload_data: bool = True) -> "Dataset":
        name = config.get("dataset.name")
        root_folder = folder
        if root_folder is None:
            root_folder = os.path.join(kge_base_dir(), "data", name)
        if os.path.isfile(os.path.join(root_folder, "dataset.yaml")):
            config.log(f"Loading configuration of dataset {name} ...")
            config.load(os.path.join(root_folder, "dataset.yaml"))
        dataset = Dataset(config, root_folder)
        if preload_data:
            dataset.entity_ids()
            dataset.relation_ids()
            for split in ["train", "valid", "test"]:
                dataset.split(split)
        return dataset

    @staticmethod
    def create_from(checkpoint: Dict, config: Optional[Config] = None,
                    dataset: Optional["Dataset"] = None,
                    preload_data: bool = False) -> "Dataset":
        """Rebuild a dataset from checkpoint metadata (no files required)."""
        if config is None:
            config = Config.create_from(checkpoint)
        if dataset is None:
            folder = None
            if "dataset" in checkpoint and checkpoint["dataset"].get("folder"):
                folder = checkpoint["dataset"]["folder"]
            if folder is None or not os.path.isdir(folder):
                default_folder = os.path.join(
                    kge_base_dir(), "data", config.get("dataset.name")
                )
                ck_ds = checkpoint.get("dataset", {})
                if os.path.isdir(default_folder):
                    dataset = Dataset.create(config, preload_data=preload_data)
                elif ck_ds.get("meta") or (
                    folder is None
                    and ck_ds.get("num_entities") is not None
                ):
                    # packaged checkpoint (id maps embedded) or an
                    # imported/ids-only one (explicit counts, no folder
                    # recorded): usable without dataset files
                    dataset = Dataset(config, folder=None)
                else:
                    # e.g. a typo'd dataset folder on resume: fail here
                    # with the real cause instead of deferring to a
                    # confusing missing-map error later
                    raise FileNotFoundError(
                        f"dataset folder {folder or default_folder!r} not "
                        "found and the checkpoint does not embed id maps "
                        "(not a packaged model)"
                    )
            else:
                dataset = Dataset.create(config, folder, preload_data=preload_data)
        if "dataset" in checkpoint:
            d = checkpoint["dataset"]
            if d.get("num_entities") is not None:
                dataset._num_entities = d["num_entities"]
            if d.get("num_relations") is not None:
                dataset._num_relations = d["num_relations"]
            for key, value in d.get("meta", {}).items():
                dataset._meta[key] = value
        return dataset

    def save_to(self, checkpoint: Dict, meta_keys: Optional[List[str]] = None) -> Dict:
        checkpoint["dataset"] = {
            "num_entities": self.num_entities(),
            "num_relations": self.num_relations(),
            "folder": self.folder,
            # stored meta keys carry form suffixes ("entity_ids::list");
            # embed every stored form of each requested base key
            "meta": {
                k: v
                for k, v in self._meta.items()
                if k.split("::")[0] in (meta_keys or [])
            },
        }
        return checkpoint

    # ------------------------------------------------------------------ caching

    def _cache_path(self, name: str) -> str:
        return os.path.join(self.folder, f"{name}.torch.cache.pkl")

    def _sources_newer_than_cache(self, cache_file: str,
                                  source_files: List[str]) -> bool:
        if not os.path.isfile(cache_file):
            return True
        cache_mtime = os.path.getmtime(cache_file)
        for f in source_files:
            if os.path.isfile(f) and os.path.getmtime(f) > cache_mtime:
                return True
        return False

    def _cached(self, name: str, source_files: List[str], build_fn):
        """Load from cache if fresh, else build and cache atomically."""
        if not self.config.get("dataset.pickle") or self.folder is None:
            return build_fn()
        cache_file = self._cache_path(name)
        stale = self._sources_newer_than_cache(cache_file, source_files)
        if stale and os.path.isfile(cache_file):
            try:
                abort = self.config.get("dataset.abort_when_cache_outdated")
            except KeyError:
                abort = False
            if abort:
                raise ValueError(
                    f"cached dataset file {cache_file} is outdated "
                    "(--abort-when-cache-outdated is set); delete the cache "
                    "or unset the flag to recompute"
                )
        if not stale:
            try:
                with open(cache_file, "rb") as f:
                    version, payload = pickle.load(f)
                if version == Dataset.CACHE_VERSION:
                    return payload
            except Exception:
                pass
        payload = build_fn()
        try:
            tmp = cache_file + f".tmp-{uuid.uuid4().hex[:8]}"
            with open(tmp, "wb") as f:
                pickle.dump((Dataset.CACHE_VERSION, payload), f)
            os.replace(tmp, cache_file)  # atomic on POSIX
        except OSError:
            pass  # read-only dataset folder: skip caching
        return payload

    # ------------------------------------------------------------------ loading

    def load_triples(self, key: str) -> np.ndarray:
        if key not in self._triples:
            filename = self.config.get(f"dataset.files.{key}.filename")
            filetype = self.config.get(f"dataset.files.{key}.type")
            if filetype != "triples":
                raise ValueError(
                    f"dataset file '{key}' has type {filetype}, expected triples"
                )
            path = os.path.join(self.folder, filename)

            def build():
                data = np.loadtxt(
                    path, dtype=np.int64, usecols=(0, 1, 2), ndmin=2
                )
                return np.ascontiguousarray(data.astype(np.int32))

            triples = self._cached(f"triples-{key}", [path], build)
            self.config.log(f"Loaded {len(triples)} {key} triples")
            self._triples[key] = triples
        return self._triples[key]

    def split(self, split: str) -> np.ndarray:
        return self.load_triples(split)

    def load_map(self, key: str, as_list: bool = False,
                 maptype: Optional[str] = None,
                 ids_key: Optional[str] = None,
                 ignore_duplicates: bool = False):
        """Load a map file into a dict or (for dense ids) list."""
        # the in-memory cache must distinguish the requested form: the
        # same key can be read as dict or list (as_list) or remapped
        # (ids_key), and returning whichever form a previous caller
        # built corrupts consumers (e.g. id inversion enumerating dict
        # keys instead of a list)
        meta_key = key
        if as_list:
            meta_key += "::list"
        if ids_key is not None:
            meta_key += f"::as-{ids_key}"
        if meta_key not in self._meta:
            filename = self.config.get(f"dataset.files.{key}.filename")
            filetype = self.config.get(f"dataset.files.{key}.type")
            if maptype and filetype != maptype and filetype != "idmap":
                raise ValueError(f"unexpected file type {filetype} for {key}")
            path = os.path.join(self.folder, filename)

            def build():
                result: Dict[Any, str] = {}
                duplicates = 0
                with open(path, "r", encoding="utf-8") as f:
                    for row in csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
                        if not row:
                            continue
                        k = row[0]
                        v = row[1] if len(row) > 1 else ""
                        if filetype != "idmap":
                            k = int(k)
                        if k in result:
                            duplicates += 1
                            if not ignore_duplicates:
                                raise KeyError(f"duplicate key {k} in {path}")
                        else:
                            result[k] = v
                if as_list and filetype != "idmap":
                    n = max(result.keys()) + 1 if result else 0
                    array: List[Optional[str]] = [None] * n
                    for k, v in result.items():
                        array[k] = v
                    return array
                return result

            if filetype == "idmap" and ids_key is not None:
                # remap external ids through an id file to dense indexes
                ids = self.load_map(ids_key, as_list=True)
                ids_path = os.path.join(
                    self.folder,
                    self.config.get(f"dataset.files.{ids_key}.filename"),
                )

                def build_idmap():
                    raw = build()
                    return [raw.get(ext) for ext in ids]

                # both source files invalidate the cache: a regenerated
                # ids file must not serve stale, misaligned strings
                payload = self._cached(
                    f"map-{key}-as-{ids_key}", [path, ids_path], build_idmap
                )
            else:
                payload = self._cached(
                    f"map-{key}{'-list' if as_list else ''}", [path], build
                )
            self.config.log(f"Loaded map {key} ({len(payload)} entries)")
            self._meta[meta_key] = payload
        return self._meta[meta_key]

    def files_of_type(self, file_type: str) -> List[str]:
        return [
            key
            for key, options in self.config.get("dataset.files").items()
            if options.get("type") == file_type
        ]

    # ------------------------------------------------------------------ metadata

    def num_entities(self) -> int:
        if self._num_entities is None:
            self._num_entities = len(self.entity_ids())
        return self._num_entities

    def num_relations(self) -> int:
        if self._num_relations is None:
            self._num_relations = len(self.relation_ids())
        return self._num_relations

    def entity_ids(self, indexes=None) -> List[str]:
        return self.map_indexes(indexes, "entity_ids")

    def relation_ids(self, indexes=None) -> List[str]:
        return self.map_indexes(indexes, "relation_ids")

    def entity_strings(self, indexes=None):
        return self.map_indexes(indexes, "entity_strings")

    def relation_strings(self, indexes=None):
        return self.map_indexes(indexes, "relation_strings")

    def meta(self, key: str):
        return self._meta[key]

    _STRING_FALLBACKS = {
        "entity_strings": "entity_ids",
        "relation_strings": "relation_ids",
    }

    def map_indexes(self, indexes, key: str):
        """Map (an array of) internal indexes to their string values.

        Human-readable strings fall back to the id maps when no strings
        file is available — notably for standalone packaged models, which
        embed only entity_ids/relation_ids (reference packages behave the
        same on disk but crash on entity_strings; here the lookup stays
        usable)."""
        the_map = self._meta.get(key)
        if the_map is None and key in self._STRING_FALLBACKS:
            fallback = self._STRING_FALLBACKS[key]
            try:
                self.config.get(f"dataset.files.{key}.filename")
                has_file = self.folder is not None and os.path.isfile(
                    os.path.join(
                        self.folder,
                        self.config.get(f"dataset.files.{key}.filename"),
                    )
                )
            except KeyError:
                has_file = False
            if not has_file and (
                fallback in self._meta
                or f"{fallback}::list" in self._meta
                or self.folder is None
            ):
                the_map = self.map_indexes(None, fallback)
        if the_map is None:
            if key in self._STRING_FALLBACKS:
                # strings files are keyed by EXTERNAL id (LibKGE layout,
                # type idmap): remap through the id file so the list
                # aligns with dense indexes (reference
                # kge/dataset.py:478-488 does the same)
                the_map = self.load_map(
                    key, as_list=True, ids_key=self._STRING_FALLBACKS[key],
                    ignore_duplicates=True,
                )
            else:
                the_map = self.load_map(key, as_list=True)
        if indexes is None:
            return the_map
        if np.isscalar(indexes) or isinstance(indexes, int):
            return the_map[int(indexes)]
        indexes = np.asarray(indexes)
        flat = [the_map[int(i)] for i in indexes.reshape(-1)]
        return np.array(flat, dtype=object).reshape(indexes.shape)

    # ------------------------------------------------------------------ indexes

    def index(self, key: str):
        if key not in self._indexes:
            if self.config.get("dataset.pickle") and self.folder:
                sources = [
                    os.path.join(self.folder, self.config.get(
                        f"dataset.files.{split}.filename"))
                    for split in self.files_of_type("triples")
                ]
                # id-derived indexes (entity/relation_id_to_index) must
                # also invalidate when the id files are regenerated;
                # including them for every index over-invalidates
                # slightly but never serves stale inversions
                for ids_key in ("entity_ids", "relation_ids"):
                    try:
                        sources.append(os.path.join(
                            self.folder, self.config.get(
                                f"dataset.files.{ids_key}.filename")
                        ))
                    except KeyError:
                        pass
                def build():
                    self.index_functions[key](self)
                    return self._indexes[key]
                self._indexes[key] = self._cached(f"index-{key}", sources, build)
            else:
                self.index_functions[key](self)
        return self._indexes[key]
