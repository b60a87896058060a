"""The port's device mesh (``kge_tpu_torch/parallel``) against
``kge_tpu``'s: mesh shapes, coordinates and groups against
``build_mesh``/``build_hybrid_mesh`` on the 8 fake CPU devices, the
choice of sharded leaves against ``params_sharding``, the row ranges,
the device of each rank, and, on 2 ``gloo`` ranks, the collectives with
autograd and the sharded K1 and K2 routes against their unsharded
results; then the row-sparse (K3) route on a 1x2 mesh against one
process, and the error of a mesh that does not match the world.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Dataset as JaxDataset
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu.parallel import distributed as jax_distributed
from kge_tpu.parallel.mesh import (
    build_mesh as jax_build_mesh, params_sharding as jax_params_sharding,
)
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.parallel import mesh as mesh_lib
from kge_tpu_torch.parallel.mesh import Mesh, mesh_shape, params_sharding
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils import misc
from kge_tpu_torch.utils.params import state_dict_from_params
from tests.torch_mesh_launch import launch, launch_ok, run_job
from tests.util import create_config, get_dataset_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = get_dataset_folder("dataset_test")
torch.set_num_threads(1)


def port_config(data, model, **options):
    config = Config()
    config.set("job.device", "cpu")
    config.set("tpu.mesh.data", data)
    config.set("tpu.mesh.model", model)
    for key, value in options.items():
        config.set(key, value, create=True)
    return config


@pytest.mark.parametrize("data,model", [(1, 1), (4, 2), (2, 2), (-1, 2)])
def test_mesh_layout_matches_kge_tpu(data, model):
    """Rank r sits where kge_tpu's mesh puts device r (the 8 CPU
    devices in id order, as processes order them), and its groups are
    its column (data) and its row (model)."""
    config = create_config("dataset_test")
    config.set("tpu.mesh.data", data)
    config.set("tpu.mesh.model", model)
    want = jax_build_mesh(config)
    world = 8 if data == -1 else data * model
    got = mesh_shape(port_config(data, model), world)
    if want is None:
        assert got is None
        return
    assert {"data": got[0], "model": got[1]} == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank in range(got[0] * got[1]):
        mesh = Mesh(*got, rank)
        assert ids[mesh.data_index, mesh.model_index] == rank
        assert mesh.data_ranks == list(ids[:, mesh.model_index])
        assert mesh.model_ranks == list(ids[mesh.data_index, :])


@pytest.mark.parametrize("data,model,devices", [
    (2, 4, 4),   # model axis past one host's devices
    (1, 3, 6),   # model axis not dividing them
    (1, 2, 4),   # a mesh that leaves devices out
])
def test_hybrid_mesh_errors_match_kge_tpu(monkeypatch, data, model, devices):
    """build_hybrid_mesh's three errors, with 2 processes of devices/2
    devices each; the port's ranks are the devices."""
    config = create_config("dataset_test")
    config.set("tpu.mesh.data", data)
    config.set("tpu.mesh.model", model)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as want:
        jax_distributed.build_hybrid_mesh(config, jax.devices()[:devices])
    with pytest.raises(ValueError) as got:
        mesh_shape(port_config(data, model), devices, devices // 2)
    assert str(got.value) == str(want.value)


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        mesh_shape(port_config(2, 2), 1)


@pytest.mark.parametrize("model_name", [
    "complex", "conve", "transh", "relational_tucker3",
])
def test_params_sharding_matches_kge_tpu(model_name):
    """The leaves a model stores as row blocks under a mesh (each rank's
    block of the padded table) are the ones kge_tpu shards over
    'model'."""
    config = create_config("dataset_test", model=model_name)
    if model_name == "conve":
        config.set("conve.round_dim", True)
    dataset = JaxDataset.create(config, DATASET)
    jax_model = JaxKgeModel.create(config, dataset)
    params = jax_model.init_params(jax.random.PRNGKey(0))
    config.set("tpu.mesh.data", 2)
    config.set("tpu.mesh.model", 2)
    specs = jax_params_sharding(jax_build_mesh(config), params)
    want = {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]
        if tuple(s.spec) == ("model", None)}
    pconfig = Config()
    pconfig.set("model", model_name)
    pconfig._import(model_name)
    pconfig.set("job.device", "cpu")
    pconfig.set("tpu.mesh.model", 2)
    if model_name == "conve":
        pconfig.set("conve.round_dim", True)
    # the mesh a 2x2 training job makes active, as rank 3 sees it
    mesh_lib.set_active(Mesh(2, 2, 3))
    try:
        model = KgeModel.create(pconfig, Dataset.create(pconfig, DATASET),
                                device=torch.device("cpu"),
                                generator=torch.Generator().manual_seed(0))
    finally:
        mesh_lib.set_active(None)
    rule = {name for name, sharded in
            params_sharding(model.named_parameters()).items() if sharded}
    assert set(model.sharded_tables()) == rule == want and want
    for name, module in model.sharded_tables().items():
        rows = module.padded_vocab_size // 2
        assert module.row_lo == rows
        assert tuple(model.get_parameter(name).shape) == (rows, module.dim)


def test_row_ranges():
    ranges = [Mesh(2, 4, r).rows(24) for r in range(8)]
    assert ranges[:4] == [(0, 6), (6, 12), (12, 18), (18, 24)]
    assert ranges[4:] == ranges[:4]
    assert [Mesh(2, 4, r).batch_rows(8) for r in (0, 3, 4, 7)] == [
        (0, 4), (0, 4), (4, 8), (4, 8)]
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(2, 4, 0).rows(10)


def test_resolve_device_takes_the_local_rank(monkeypatch):
    """auto and cuda mean the current card alone, cuda:LOCAL_RANK in a
    process group (ranks past the node's cards share them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    config = port_config(1, 1)
    for name in ("auto", "cuda"):
        config.set("job.device", name)
        assert misc.resolve_device(config) == torch.device("cuda")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    for local_rank, want in (("1", "cuda:1"), ("3", "cuda:1"),
                             ("0", "cuda:0")):
        monkeypatch.setenv("LOCAL_RANK", local_rank)
        for name in ("auto", "cuda"):
            config.set("job.device", name)
            assert misc.resolve_device(config) == torch.device(want)
    config.set("job.device", "cuda:0")
    assert misc.resolve_device(config) == torch.device("cuda:0")


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    launch_ok(2, ["-m", "tests.torch_mesh_launch", "collectives",
                  json.dumps({"out": out})])
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(2)]


@pytest.mark.parametrize("check,tol", [
    ("lookup", 0.0), ("lookup_grad", 0.0), ("gather", 0.0),
    ("gather_grad", 0.0), ("model_sum", 1e-5), ("model_sum_grad", 0.0),
    ("halo", 0.0), ("halo_grad", 1e-6), ("enter_grad", 1e-5),
])
def test_collectives_with_autograd(collectives, check, tol):
    """The vocab-parallel lookup, the table gather, the model sum and
    the R-GNN halo route's exchange and weights' entry, forward and
    backward, against plain indexing on the whole table."""
    for rank in collectives:
        assert rank[check] <= tol


def test_sharded_k1_route_at_ragged_batch(collectives):
    """Each data rank's rows of a 7-row batch through the fused loss,
    the loss and the candidates' gradient summed over the data group,
    against the reference on the whole batch."""
    for rank in collectives:
        assert rank["k1"] <= 1e-5
        assert rank["k1_grad_q"] <= 1e-6
        assert rank["k1_grad_cand"] <= 1e-6


def test_sharded_k2_route_with_nondivisible_vocab(collectives):
    """13 candidates over a model axis of 2 (padded to 16, padding
    invalid): the counts summed over the model group equal the
    unsharded counts exactly."""
    for rank in collectives:
        assert rank["k2"] == 0.0


NEGSAMP = {
    "job": {"type": "train", "device": "cpu"},
    "dataset": {"name": "dataset_test"},
    "model": "complex",
    "lookup_embedder": {"dim": 16},
    "train": {"type": "negative_sampling", "loss": "kl", "batch_size": 8,
              "max_epochs": 1,
              "optimizer": {"default": {"type": "Adagrad",
                                        "args": {"lr": 0.2}}}},
    "negative_sampling": {"num_samples": {"s": 2, "o": 2}, "shared": True,
                          "implementation": "batch"},
    "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered"},
    "eval": {"batch_size": 8},
    "random_seed": {"default": 11},
    "console": {"quiet": True},
    "tpu": {"on_device_sampling": "never", "steps_per_dispatch": 1},
}


def write_config(folder, config):
    """``config`` as ``<folder>/config.yaml``; its path."""
    path = os.path.join(str(folder), "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def single_process(config_file, options, dataset=DATASET):
    """The port's job on one process: its epochs' (loss, cost), its
    tables and its job."""
    config = Config()
    config.load(config_file, create=True)
    for key, value in options.items():
        config.set(key, value, create=True)
    job = Job.create(config, Dataset.create(config, dataset))
    losses = []
    job.post_epoch_hooks.append(lambda j: losses.append(
        [j.current_trace["epoch"][k] for k in ("avg_loss", "avg_cost")]))
    job.run()
    tables = {k: v.numpy() for k, v in
              state_dict_from_params(job.model.params()).items()}
    return losses, tables, job


@pytest.mark.parametrize("optimizer", ["Adagrad", "sgd"])
def test_row_sparse_on_a_model_axis_matches_one_process(tmp_path, optimizer):
    """Row-sparse updates (K3) on a 1x2 mesh: each rank updates the rows
    its block owns; the tables after an epoch are one process's."""
    config_file = write_config(tmp_path, NEGSAMP)
    options = {"tpu.sparse_updates": "always",
               "negative_sampling.implementation": "triple",
               "negative_sampling.shared": False,
               "train.optimizer.default.type": optimizer,
               "valid.every": 0}
    want_losses, want, _ = single_process(config_file, options)
    out = str(tmp_path / "mesh")
    results = run_job(2, {"config": config_file, "dataset": DATASET,
                          "out": out, "tables": True,
                          "options": {**options, "tpu.mesh.model": 2}})
    np.testing.assert_allclose(results[0]["losses"], want_losses, rtol=1e-6)
    got = np.load(os.path.join(out, "tables.npz"))
    for name, table in want.items():
        np.testing.assert_allclose(got[name], table, rtol=1e-6, atol=1e-6)


def test_mesh_that_does_not_match_the_world_raises(tmp_path):
    config_file = write_config(tmp_path, NEGSAMP)
    spec = {"config": config_file, "dataset": DATASET, "out": str(tmp_path),
            "options": {"tpu.mesh.data": 2, "tpu.mesh.model": 2}}
    rcs, outs = launch(2, ["-m", "tests.torch_mesh_launch", "train",
                           json.dumps(spec)])
    for rc, out in zip(rcs, outs):
        assert rc != 0
        assert "multi-host meshes must use every device" in out

