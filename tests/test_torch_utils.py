"""The port's utilities against kge_tpu's on the same files:

- ``dump trace``: the CSV (and YAML) byte for byte kge_tpu's on the same
  ``trace.yaml``, for a resumed training run under every entry filter and
  for a search folder;
- ``dump checkpoint``: the same keys and parameter names (a list in the
  params tree included), the whole printout equal;
- ``package``: the same packaged model (params, state, embedded id maps)
  from the same checkpoint, each package loading the other's; and
  ``lookup_embedder.pretrain``: the rows whose ids the package has are the
  package's, bit for bit, in both packages, with ``ensure_all``;
- ``import-libkge``: a hand-built LibKGE-style checkpoint (every state-dict
  key kge_tpu's importer reads, random values) gives kge_tpu's params
  tree, model state and dataset sizes, for ComplEx without a dataset
  folder, reciprocal ConvE with batch-norm statistics and CompGCN;
- ``preprocess``: the files byte for byte kge_tpu's on
  tests/data/dataset_preprocess.
"""

import argparse
import copy
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import Ctx as JaxCtx, KgeModel as JaxKgeModel
from kge_tpu.utils import dump as jax_dump
from kge_tpu.utils.import_libkge import (
    apply_reference_state_dict, import_reference_checkpoint as jax_import)
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu.utils.package import package_model as jax_package
from kge_tpu.utils.preprocess import (
    preprocess_default as jax_preprocess, preprocess_wn11 as jax_wn11)
from kge_tpu_torch import Config, Dataset, cli
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.utils.import_libkge import import_reference_checkpoint
from kge_tpu_torch.utils.io import load_checkpoint
from kge_tpu_torch.utils.package import package_model
from kge_tpu_torch.utils.preprocess import preprocess_default, preprocess_wn11

from tests.util import get_dataset_folder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, "data", "toy")
CPU = ["--job.device", "cpu", "--console.quiet", "true"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A toy KvsAll run (1 epoch, resumed to 2, validated each epoch) of
    reciprocal ConvE and a toy grid search, both by the port."""
    root = tmp_path_factory.mktemp("runs")
    train = str(root / "conve")
    dims = ["--conve.entity_embedder.dim", "8",
            "--conve.relation_embedder.dim", "8"]
    cli.main(["start", "examples/toy-conve-train.yaml", "--folder", train,
              "--train.max_epochs", "1", "--valid.every", "1",
              "--train.trace_level", "batch", *dims, *CPU])
    cli.main(["resume", train, "--train.max_epochs", "2", *CPU])
    search = str(root / "grid")
    cli.main(["start", "examples/toy-complex-search-grid.yaml", "--folder",
              search, "--train.max_epochs", "1", "--valid.every", "1",
              "--train.type", "1vsAll", *CPU])
    return {"train": train, "search": search}


def _dump_args(argv):
    parser = argparse.ArgumentParser()
    jax_dump.add_dump_parsers(parser)
    return parser.parse_args(argv)


def _both_dumps(argv, capsys):
    """(kge_tpu's printout, the port's) of ``dump <argv>``."""
    capsys.readouterr()
    jax_dump.dump(_dump_args(argv))
    want = capsys.readouterr().out
    cli.main(["dump", *argv])
    return want, capsys.readouterr().out


TRACE_FLAGS = {
    "default": [], "train": ["--train"], "valid": ["--valid"],
    "yaml": ["--yaml"], "batch": ["--train", "--batch"],
    "keys": ["--keys", "epoch_time", "size", "--no-default-keys"],
    "max-epoch": ["--max-epoch", "1"], "truncate": ["--truncate"],
    "checkpoint": ["--checkpoint"], "list-keys": ["--list-keys"],
}


@pytest.mark.parametrize("flags", list(TRACE_FLAGS))
def test_dump_trace_equals_kge_tpu(runs, flags, capsys):
    want, got = _both_dumps(["trace", runs["train"], *TRACE_FLAGS[flags]],
                            capsys)
    assert got == want
    assert len(got.splitlines()) > 1


@pytest.mark.parametrize("flags", [[], ["--search"], ["--search", "--yaml"]])
def test_dump_trace_of_search_folder_equals_kge_tpu(runs, flags, capsys):
    want, got = _both_dumps(["trace", runs["search"], *flags], capsys)
    assert got == want
    assert got.count("\n") >= 5  # four trials and the search's summary


def test_dump_checkpoint_equals_kge_tpu(runs, capsys):
    source = os.path.join(runs["train"], "checkpoint_00002.pt")
    want, got = _both_dumps(["checkpoint", source], capsys)
    assert got == want
    printed = yaml.safe_load(got)
    assert printed["parameter_names"] == [
        "entity_embedder.weights", "relation_embedder.weights",
        "scorer.conv_b", "scorer.conv_w", "scorer.proj_b", "scorer.proj_w"]
    names = yaml.safe_load(_both_dumps(
        ["checkpoint", source, "--keys", "epoch", "parameter_names"],
        capsys)[1])
    assert set(names) == {"epoch", "parameter_names"}


def test_dump_checkpoint_names_list_entries_as_kge_tpu(tmp_path, capsys):
    """A params tree with a list (the Transformer's layers): the names
    ``jax.tree_util.tree_flatten_with_path`` gives (``[i]``)."""
    folder = str(tmp_path / "transformer")
    cli.main(["start", "examples/toy-transformer-train.yaml", "--folder",
              folder, "--train.max_epochs", "1", *CPU])
    want, got = _both_dumps(
        ["checkpoint", os.path.join(folder, "checkpoint_00001.pt"),
         "--keys", "parameter_names"], capsys)
    assert got == want and "scorer.layers.[0].qkv_w" in got


def test_dump_config_equals_kge_tpu(runs, capsys):
    """Equal printouts, but that the full configuration names the port's
    modules where kge_tpu's names its own."""
    for flags in ([], ["--raw"], ["--minimal"],
                  ["--minimal", "--include", "train", "--exclude",
                   "train.optimizer"]):
        want, got = _both_dumps(["config", runs["train"], *flags], capsys)
        if not flags:
            assert "- kge_tpu_torch.search" in got
            got = got.replace("- kge_tpu_torch.", "- kge_tpu.")
        assert got == want, flags


def _trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_package_and_pretrain_equal_kge_tpu(runs, tmp_path):
    checkpoint = os.path.join(runs["train"], "checkpoint_best.pt")
    port_file = package_model(checkpoint, str(tmp_path / "port.pt"))
    jax_file = jax_package(checkpoint, str(tmp_path / "jax.pt"))
    for mine, theirs in ((load_checkpoint(port_file),
                          jax_load_checkpoint(jax_file)),
                         (jax_load_checkpoint(port_file),
                          load_checkpoint(jax_file))):
        assert mine["type"] == theirs["type"] == "package"
        _trees_equal(mine["model"], theirs["model"])
        assert mine["dataset"]["meta"] == theirs["dataset"]["meta"]
        assert mine["dataset"]["num_entities"] == 120
    # kge_tpu loads the port's package with the dataset folder gone
    packaged = jax_load_checkpoint(port_file)
    packaged["dataset"]["folder"] = str(tmp_path / "gone")
    model, _, _ = JaxKgeModel.create_from(packaged)
    assert model.dataset.entity_ids()[:3] == Dataset.create(
        Config.create_from(load_checkpoint(checkpoint)),
        TOY).entity_ids()[:3]

    # pretrain from either package's file: the rows are the package's
    table = load_checkpoint(port_file)["model"]["params"]
    for package_file in (port_file, jax_file):
        # the reciprocal model's relation ids include the inverses, which
        # the package does not name: ensure_all for the entities only
        options = {f"conve.{key}.{option}": value
                   for key in ("entity_embedder", "relation_embedder")
                   for option, value in (
                       ("pretrain.model_filename", package_file),
                       ("pretrain.ensure_all", key == "entity_embedder"),
                       ("dim", 8))}
        rows = {}
        for cls, dataset_cls in ((JaxConfig, JaxDataset), (Config, Dataset)):
            config = cls()
            config.load(os.path.join(REPO, "examples",
                                     "toy-conve-train.yaml"), create=True)
            for key, value in {"job.device": "cpu", **options}.items():
                config.set(key, value, create=True)
            dataset = dataset_cls.create(config, TOY)
            if cls is JaxConfig:
                model = JaxKgeModel.create(config, dataset)
                tree = model.init_params(jax.random.PRNGKey(0))
            else:
                tree = KgeModel.create(
                    config, dataset, device=torch.device("cpu"),
                    generator=torch.Generator().manual_seed(0)).params()
            rows[cls.__module__] = {
                k: np.asarray(tree[k]["weights"])
                for k in ("entity_embedder", "relation_embedder")}
        # the dataset's ids: every entity, and the relations (not the
        # reciprocal table's inverse rows after them)
        for key, n in (("entity_embedder", 120), ("relation_embedder", 9)):
            want = table[key]["weights"][:n]
            for got in rows.values():
                np.testing.assert_array_equal(got[key][:n], want,
                                              err_msg=key)


def test_pretrain_ensure_all_refuses_missing_ids(runs, tmp_path):
    """A package whose ids do not cover the dataset's: refused with
    ensure_all, as in kge_tpu; the rows stay the initializer's without."""
    package_file = package_model(
        os.path.join(runs["train"], "checkpoint_best.pt"),
        str(tmp_path / "model.pt"))
    config = Config()
    config.set("model", "complex")
    config._import("complex")
    config.set("lookup_embedder.pretrain.model_filename", package_file)
    config.set("lookup_embedder.dim", 9)
    dataset = Dataset.create(config, get_dataset_folder("dataset_test"))
    shared = set(dataset.entity_ids()) & set(
        Dataset.create_from(load_checkpoint(package_file)).entity_ids())
    assert not shared
    plain = KgeModel.create(config, dataset, device=torch.device("cpu"),
                            generator=torch.Generator().manual_seed(0))
    config.set("lookup_embedder.pretrain.ensure_all", True)
    with pytest.raises(ValueError, match="does not cover all ids"):
        KgeModel.create(config, dataset, device=torch.device("cpu"),
                        generator=torch.Generator().manual_seed(0))
    config.set("lookup_embedder.pretrain.model_filename", "")
    fresh = KgeModel.create(config, dataset, device=torch.device("cpu"),
                            generator=torch.Generator().manual_seed(0))
    _trees_equal(plain.params(), fresh.params())


# ---------------------------------------------------------------- import

CONVE_KEYS = ["_scorer.convolution.weight", "_scorer.bn1.running_mean",
              "_scorer.bn2.running_mean"]
#: name -> (LibKGE config, dataset folder, the keys kge_tpu's importer
#: tests with ``in`` before it reads them)
LIBKGE = {
    "complex": ({"model": "complex", "lookup_embedder": {"dim": 8}}, None,
                []),
    "reciprocal-conve": ({
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model": {"base_model": {"type": "conve"}},
        "conve": {"entity_embedder": {"dim": 8},
                  "relation_embedder": {"dim": 8}}}, TOY, CONVE_KEYS),
    "compgcn": ({"model": "compgcn",
                 "compgcn": {"entity_embedder": {"dim": 8},
                             "relation_embedder": {"dim": 8}}}, TOY,
                CONVE_KEYS + ["_encoder.rgnn.gnn_layers.0.bn.running_mean"]),
}


class _Probe(dict):
    """A state dict that remembers the key read last."""

    def __getitem__(self, key):
        self.last = key
        return super().__getitem__(key)


def libkge_state_dict(options, dataset_folder, optional_keys):
    """Every state-dict key kge_tpu's importer reads for the model of
    ``options``, with random values of the reference's shapes (embedding
    tables unpadded): its reads probed one at a time."""
    config = JaxConfig()
    config.folder = None
    config.set("model", options["model"])
    config._import(options["model"])
    config.load_options({k: v for k, v in options.items() if k != "model"},
                        create=True)
    config.set("job.device", "cpu")
    dataset = JaxDataset.create(config, dataset_folder or TOY)
    model = JaxKgeModel.create(config, dataset)
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map(np.asarray, model.init_state())
    rows = {"entity": model.get_s_embedder().vocab_size,
            "relation": model.get_p_embedder().vocab_size}
    rng = np.random.default_rng(1)
    placeholder = np.zeros((0,), np.float32)
    sd = _Probe((k, placeholder) for k in optional_keys)
    while True:
        try:
            apply_reference_state_dict(model, copy.deepcopy(params),
                                       copy.deepcopy(state), sd)
            break
        except KeyError as e:
            if e.args[0] in sd:  # not a state-dict key
                raise
            sd[e.args[0]] = placeholder
        except ValueError as e:
            shape = [int(x) for x in re.search(
                r"ours \(([\d, ]*)\)", str(e)).group(1).split(",") if x]
            if sd.last.endswith("_embeddings.weight"):
                shape[0] = rows["entity" if "entity" in sd.last
                                else "relation"]
            value = rng.normal(size=shape).astype(np.float32)
            if "running_var" in sd.last:
                value = np.abs(value) + 0.5
            sd[sd.last] = value
    return {k: torch.from_numpy(v) for k, v in sd.items() if v.size}


@pytest.mark.parametrize("name", list(LIBKGE))
def test_import_libkge_equals_kge_tpu(name, tmp_path):
    options, dataset_folder, optional_keys = LIBKGE[name]
    sd = libkge_state_dict(options, dataset_folder, optional_keys)
    path = str(tmp_path / "libkge.pt")
    torch.save({"type": "train", "epoch": 7, "job_id": "refjob",
                "valid_trace": [], "model": (sd, {}),
                "config": {**options, "job": {"device": "cuda"}}}, path)
    want = jax_import(path, dataset_folder=dataset_folder)
    got = import_reference_checkpoint(path, dataset_folder=dataset_folder)
    assert got["type"] == want["type"] == "import" and got["epoch"] == 7
    _trees_equal(got["model"]["params"],
                 jax.tree_util.tree_map(np.asarray, want["model"]["params"]))
    _trees_equal(got["model"]["state"],
                 jax.tree_util.tree_map(np.asarray, want["model"]["state"]))
    for key in ("num_entities", "num_relations"):
        assert got["dataset"][key] == want["dataset"][key]
    if name == "reciprocal-conve":
        np.testing.assert_array_equal(
            got["model"]["state"]["bn1"]["mean"],
            sd["_scorer.bn1.running_mean"].numpy())
    # both packages load the port's file
    model = KgeModel.create_from(got, device=torch.device("cpu"))
    jax_model, jax_params, jax_state = JaxKgeModel.create_from(
        copy.deepcopy(got))
    ids = np.arange(4)
    with torch.no_grad():
        scores = model.score_sp(torch.as_tensor(ids),
                                torch.as_tensor(ids % 2)).numpy()
    np.testing.assert_allclose(
        scores, np.asarray(jax_model.score_sp(
            jax_params, ids, ids % 2, ctx=JaxCtx(state=jax_state))),
        rtol=1e-4)  # the random N(0, 1) weights score in the thousands


# ---------------------------------------------------------------- preprocess


@pytest.mark.parametrize("pipeline", ["default", "default-sop", "wn11"])
def test_preprocess_writes_kge_tpu_files(pipeline, tmp_path, capsys):
    src = get_dataset_folder("dataset_preprocess")
    folders = {}
    for name, default, wn11 in (("jax", jax_preprocess, jax_wn11),
                                ("port", preprocess_default,
                                 preprocess_wn11)):
        folder = str(tmp_path / name / "raw")  # the dataset's name
        shutil.copytree(src, folder)
        if pipeline == "wn11":
            _labeled_splits(folder)
            wn11(folder, seed=4)
        else:
            default(folder, order_sop=pipeline == "default-sop", seed=4)
        folders[name] = folder
    files = sorted(os.listdir(folders["jax"]))
    assert files == sorted(os.listdir(folders["port"]))
    assert "dataset.yaml" in files and "train_sample.del" in files
    for name in files:
        with open(os.path.join(folders["jax"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(folders["port"], name), "rb") as f:
            assert f.read() == want, name


def _labeled_splits(folder):
    """valid/test with a +1/-1 label column (WN11's layout)."""
    for split in ("valid.txt", "test.txt"):
        path = os.path.join(folder, split)
        with open(path) as f:
            rows = [line.rstrip("\n") for line in f if line.strip()]
        with open(path, "w") as f:
            for i, row in enumerate(rows):
                f.write(f"{row}\t{1 if i % 2 == 0 else -1}\n")
