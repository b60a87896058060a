"""The port's R-GNN encoders on a device mesh, 2 or 4 ``gloo`` ranks on
the host (``tests/torch_mesh_launch.py``), on data/toy at dim 16 with a
DistMult decoder by negative sampling: each held to its own one-process
run and, where ``kge_tpu`` runs the same job on its 2x2 mesh of fake CPU
devices, to that run started from the same checkpoint.

- CompGCN with ``sub`` and RAGAT (propagation dropout 0) take the halo
  route (the boundary exchange counted on every rank) on 1x2 and 2x2
  meshes: epoch losses within 1e-5 of one process, the first epoch
  within 1e-4 of ``kge_tpu``'s 2x2 mesh (the bound ``kge_tpu`` holds its
  own mesh to, tests/test_sharding.py).

Dropout, checkpoints, the gathered route, graph sampling, the halo
layout and the dense adjacency are in tests/test_torch_rgnn_routes.py
(each file stays near a minute on one worker).
"""

import os

import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from tests.test_torch_mesh import single_process, write_config
from tests.torch_mesh_launch import REPO, run_job

torch.set_num_threads(1)
TOY = os.path.join(REPO, "data", "toy")
MESHES = {"1x2": {"tpu.mesh.data": 1, "tpu.mesh.model": 2},
          "2x2": {"tpu.mesh.data": 2, "tpu.mesh.model": 2}}


def rgnn_config(preset, encoder=None, **top):
    """A small R-GNN job on data/toy: ``preset``'s encoder (with
    ``encoder`` over it, entity dropout 0 unless set), dim 16, DistMult,
    negative sampling with Adam, 2 epochs, no validation."""
    config = {
        "job": {"type": "train", "device": "cpu"},
        "dataset": {"name": "toy"},
        "model": preset,
        preset: {"entity_embedder": {"dim": 16},
                 "relation_embedder": {"dim": 16},
                 "encoder": {"emb_entity_dropout": 0.0, **(encoder or {})},
                 "decoder": {"model": "distmult", "type": "distmult"}},
        "train": {"type": "negative_sampling", "loss": "kl",
                  "batch_size": 64, "max_epochs": 2,
                  "optimizer": {"default": {"type": "Adam",
                                            "args": {"lr": 0.01}}}},
        "negative_sampling": {"num_samples": {"s": 3, "o": 3}},
        "valid": {"every": 0, "metric": "mean_reciprocal_rank_filtered"},
        "eval": {"batch_size": 64},
        "random_seed": {"default": 21},
        "console": {"quiet": True},
        "tpu": {"on_device_sampling": "never", "steps_per_dispatch": 1},
    }
    config.update(top)
    return config


def mesh_run(root, name, config_file, mesh, **spec):
    """Every rank's result of the job on ``mesh`` (a MESHES key)."""
    options = MESHES[mesh]
    n = options["tpu.mesh.data"] * options["tpu.mesh.model"]
    return run_job(n, {"config": config_file, "dataset": TOY,
                       "out": str(root / f"{name}-{mesh}"),
                       "options": options, **spec})


def jax_mesh_run(config_file, folder):
    """kge_tpu's job on its 2x2 mesh: its epochs' avg_loss (its initial
    checkpoint, ``checkpoint_00000.pt``, is in ``folder``)."""
    config = JaxConfig(folder=folder)
    config.load(config_file, create=True)
    for key, value in MESHES["2x2"].items():
        config.set(key, value)
    config.init_folder()
    job = JaxTrainingJob.create(config, JaxDataset.create(config, TOY))
    losses = []
    job.post_epoch_hooks.append(lambda j: losses.append(
        j.current_trace["epoch"]["avg_loss"]))
    job.run()
    return losses


def halo_case(root, name, preset, encoder):
    """One process, 1x2 and 2x2 of the job, and the port's 2x2 from
    kge_tpu's 2x2 mesh's initial checkpoint against kge_tpu's first
    epoch."""
    config_file = write_config(root, rgnn_config(preset, encoder))
    want, _, _ = single_process(config_file, {}, dataset=TOY)
    runs = {mesh: mesh_run(root, name, config_file, mesh) for mesh in MESHES}
    (root / "jax").mkdir()
    jax_file = write_config(root / "jax", rgnn_config(
        preset, encoder, train={**rgnn_config(preset)["train"],
                                "max_epochs": 1}))
    jax_folder = str(root / "jax" / "run")
    jax_losses = jax_mesh_run(jax_file, jax_folder)
    from_jax = run_job(4, {
        "config": jax_file, "dataset": TOY, "out": str(root / "from-jax"),
        "options": MESHES["2x2"],
        "resume": os.path.join(jax_folder, "checkpoint_00000.pt")})
    return dict(single=want, runs=runs, jax=jax_losses, from_jax=from_jax)


HALO_CASES = {
    "compgcn-sub": ("compgcn", {"num_layers": 2,
                                "message_passing_args": {
                                    "composition": "sub"}}),
    "ragat": ("ragat", {"message_passing_args": {
        "composition": "mult_weighted", "num_heads": 2,
        "emb_propagation_dropout": 0.0}}),
}


@pytest.fixture(scope="module", params=list(HALO_CASES))
def halo_runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    preset, encoder = HALO_CASES[request.param]
    return halo_case(root, request.param, preset, encoder)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_halo_route_matches_one_process(halo_runs, mesh):
    """The halo route engaged on every rank (its exchanges counted), and
    every rank's epoch losses are one process's."""
    results = halo_runs["runs"][mesh]
    for result in results:
        assert result["halo_exchanges"] > 0
        assert result["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"], halo_runs["single"],
                               rtol=1e-5)


def test_halo_route_matches_kge_tpu_mesh(halo_runs):
    """From kge_tpu's initial checkpoint, the port's 2x2 mesh's first
    epoch is kge_tpu's 2x2 mesh's, which takes its halo route too."""
    port = halo_runs["from_jax"][0]
    assert port["halo_exchanges"] > 0
    np.testing.assert_allclose(port["losses"][0][0], halo_runs["jax"][0],
                               rtol=1e-4)
