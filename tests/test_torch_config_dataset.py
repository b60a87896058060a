"""The port's Config and Dataset (kge_tpu_torch/config.py, dataset.py,
indexing.py) against kge_tpu's: the same YAML and checkpoint configs
load to the same values with the module list rewritten to the port, the
same triples and label coordinates come out, and the port never writes
or reads a cache file under a name kge_tpu uses.
"""

import io
import os
import pickle
import shutil

import numpy as np
import pytest

import kge_tpu
from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.config import port_modules
from kge_tpu_torch.utils.io import CheckpointUnpickler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_YAML = os.path.join(REPO, "examples", "toy-complex-train.yaml")
TOY_DATA = os.path.join(REPO, "data", "toy")


def _flat_without_modules(config):
    flat = dict(config.flatten(config.options))
    modules = flat.pop("modules")
    return flat, modules


def _assert_same_values(mine, ref):
    mine_flat, modules = _flat_without_modules(mine)
    ref_flat, _ = _flat_without_modules(ref)
    assert set(mine_flat) == set(ref_flat)
    for key, value in ref_flat.items():
        if value != value:  # NaN defaults (train.loss_arg)
            assert mine_flat[key] != mine_flat[key], key
        else:
            assert mine_flat[key] == value, key
    assert modules and all(m.startswith("kge_tpu_torch.") for m in modules)


def test_config_loads_kge_tpu_yaml():
    mine, ref = Config(), JaxConfig()
    mine.load(TOY_YAML, create=True)
    ref.load(TOY_YAML, create=True)
    _assert_same_values(mine, ref)
    assert mine.get("lookup_embedder.dim") == 64
    assert mine.get("complex.class_name") == "ComplEx"


def test_config_loads_kge_tpu_checkpoint_config():
    """A checkpoint's config is a pickled kge_tpu.config.Config whose
    modules name kge_tpu's: the port unpickles it into its own Config
    and rewrites the modules."""
    ref = JaxConfig()
    ref.load(TOY_YAML, create=True)
    ref.set("eval.batch_size", 17)
    data = pickle.dumps({"config": ref, "type": "train"})
    checkpoint = CheckpointUnpickler(io.BytesIO(data)).load()
    assert isinstance(checkpoint["config"], Config)
    mine = Config.create_from(checkpoint)
    _assert_same_values(mine, JaxConfig.create_from(
        {"config": ref, "type": "train"}))
    assert mine.get("eval.batch_size") == 17


def test_port_config_in_a_checkpoint_loads_in_kge_tpu():
    mine = Config()
    mine.load(TOY_YAML, create=True)
    checkpoint = mine.save_to({})
    assert isinstance(checkpoint["config"], dict)
    assert all(m.startswith("kge_tpu.") for m in checkpoint["config"]["modules"])
    ref = JaxConfig.create_from(pickle.loads(pickle.dumps(checkpoint)))
    assert ref.modules() == JaxConfig().modules()
    assert ref.get("lookup_embedder.dim") == 64


def test_port_modules_rewrite():
    assert port_modules(["kge_tpu.models", "kge_tpu.search", "my.plugin"]) \
        == ["kge_tpu_torch.models", "my.plugin"]


@pytest.fixture
def toy_copy(tmp_path):
    """data/toy without any cache files."""
    folder = tmp_path / "toy"
    folder.mkdir()
    for name in os.listdir(TOY_DATA):
        if not name.endswith(".pkl"):
            shutil.copy(os.path.join(TOY_DATA, name), folder / name)
    return str(folder)


def _both(folder):
    mine_config, ref_config = Config(), JaxConfig()
    for c in (mine_config, ref_config):
        c.set("dataset.name", "toy")
        c.set("console.quiet", True)
    return (Dataset.create(mine_config, folder),
            JaxDataset.create(ref_config, folder))


def test_dataset_equals_kge_tpu(toy_copy):
    mine, ref = _both(toy_copy)
    assert mine.num_entities() == ref.num_entities()
    assert mine.num_relations() == ref.num_relations()
    assert mine.entity_ids() == ref.entity_ids()
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(mine.split(split), ref.split(split))
        assert mine.split(split).dtype == np.int32
    queries = ref.split("test")
    for key, cols in (("sp_to_o", [0, 1]), ("po_to_s", [1, 2])):
        for split in ("train", "valid", "test"):
            got = mine.index(f"{split}_{key}").get_all_coords(
                queries[:, cols], return_counts=True)
            want = ref.index(f"{split}_{key}").get_all_coords(
                queries[:, cols], return_counts=True)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    assert mine.index("relation_types") == ref.index("relation_types")
    assert mine.index("frequency_percentiles") == \
        ref.index("frequency_percentiles")


def test_dataset_cache_files_are_the_ports_own(toy_copy):
    """The port's caches never take a name kge_tpu reads (its caches
    pickle kge_tpu.indexing objects), and a second load reads them."""
    before = set(os.listdir(toy_copy))
    mine, ref = _both(toy_copy)
    mine.index("train_sp_to_o")
    ref.index("train_sp_to_o")
    after_both = set(os.listdir(toy_copy))
    ported = {n for n in after_both - before if ".torch." in n}
    reference = {n for n in after_both - before if ".torch." not in n}
    assert ported and reference
    assert all(n.endswith(".torch.cache.pkl") for n in ported)
    assert {n.replace(".torch.cache.pkl", ".cache.pkl") for n in ported} \
        <= reference
    # replace kge_tpu's caches with garbage: the port must not open them
    for name in reference:
        with open(os.path.join(toy_copy, name), "wb") as f:
            f.write(b"not a pickle")
    again = Config()
    again.set("dataset.name", "toy")
    dataset = Dataset.create(again, toy_copy)
    np.testing.assert_array_equal(dataset.split("train"),
                                  mine.split("train"))
    dataset.index("train_sp_to_o")
    assert set(os.listdir(toy_copy)) == after_both


def test_dataset_create_from_checkpoint_without_files():
    checkpoint = {
        "type": "package",
        "config": {"dataset": {"name": "no-such-dataset"}},
        "dataset": {"num_entities": 7, "num_relations": 3, "folder": None,
                    "meta": {"entity_ids::list": [str(i) for i in range(7)]}},
    }
    config = Config.create_from(checkpoint)
    dataset = Dataset.create_from(checkpoint, config)
    assert dataset.num_entities() == 7 and dataset.num_relations() == 3
    assert dataset.folder is None


def test_port_package_has_no_reference_imports():
    import re

    root = os.path.join(REPO, "kge_tpu_torch")
    pattern = re.compile(r"^\s*(import|from) (jax|optax|kge_tpu)(\.|\s|$)")
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    for line in f:
                        assert not pattern.match(line), (name, line)
    assert kge_tpu.__name__ == "kge_tpu"  # the reference stays importable
