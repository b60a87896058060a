"""The port's training on a device mesh, 2 or 4 ``gloo`` ranks on the
host, held against ``kge_tpu``'s mesh on the 8 fake CPU devices
(``dataset_test``, ComplEx dim 16, batch 8, one epoch, as
``tests/test_sharding.py``) and against its own single-process run: the
fused negative-sampling loss (K1 on each rank's rows) with a validation
(K2 on each model rank's block), KvsAll and 1vsAll through the gathered
table, ConvE's dropout and batch-norm statistics over a data axis;
checkpoints crossing between mesh and single-device runs of both
packages; and the multi-process bookkeeping (rank 0 writes, the others
log to ``proc<i>/``, folders and seeds agree).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_mesh import (
    DATASET, NEGSAMP, single_process, write_config,
)
from tests.torch_mesh_launch import launch, run_job

torch.set_num_threads(1)
MESH_2X2 = {"tpu.mesh.data": 2, "tpu.mesh.model": 2}


def jax_run(config_file, options, folder):
    """kge_tpu's job in-process: its epochs' avg_loss, its validations'
    filtered MRR and its job."""
    config = JaxConfig(folder=folder)
    config.load(config_file, create=True)
    for key, value in options.items():
        config.set(key, value, create=True)
    config.init_folder()
    job = JaxTrainingJob.create(config, JaxDataset.create(config, DATASET))
    losses = []
    job.post_epoch_hooks.append(lambda j: losses.append(
        j.current_trace["epoch"]["avg_loss"]))
    job.run()
    return losses, [t["mean_reciprocal_rank_filtered"]
                    for t in job.valid_trace], job


def example_ranks(folder):
    """The validation's per-triple ranks from a run's trace."""
    with open(os.path.join(folder, "trace.yaml")) as f:
        entries = [yaml.safe_load(line) for line in f]
    return [(e["s"], e["p"], e["o"], e["rank_s_filtered"],
             e["rank_o_filtered"], e["rank_s"], e["rank_o"])
            for e in entries if e.get("scope") == "example"]


def eval_mrr(folder, checkpoint_file, jax, dataset=DATASET):
    """The validation MRR of a checkpoint, evaluated on one device by
    kge_tpu (``jax``) or the port on one process."""
    cls, job_cls, dataset_cls, load = (
        (JaxConfig, JaxJob, JaxDataset, jax_load_checkpoint) if jax
        else (Config, Job, Dataset, load_checkpoint))
    config = cls(folder=folder)
    config.load(os.path.join(folder, "config.yaml"), create=True)
    for key, value in {"job.type": "eval", "eval.split": "valid",
                       "job.device": "cpu", "valid.trace_level": "epoch",
                       "eval.trace_level": "epoch"}.items():
        config.set(key, value)
    job = job_cls.create_from(load(checkpoint_file), new_config=config,
                              dataset=dataset_cls.create(config, dataset))
    job.verbose = False
    return job.run()["mean_reciprocal_rank_filtered"]


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    """The fused negative-sampling job with a validation on kge_tpu's
    2x2 mesh (its kernels in interpret mode) and on the port's 4 ranks,
    which start from kge_tpu's initial checkpoint (the two packages draw
    their initial tables from different generators)."""
    root = tmp_path_factory.mktemp("fused")
    config_file = write_config(root, {
        **NEGSAMP,
        "valid": {**NEGSAMP["valid"], "trace_level": "example"},
        "tpu": {**NEGSAMP["tpu"], "fused_negsamp_loss": "always"},
    })
    jax_folder = str(root / "jax")
    jax_losses, jax_mrr, _ = jax_run(config_file, MESH_2X2, jax_folder)
    folder = str(root / "port")
    results = run_job(4, {"config": config_file, "dataset": DATASET,
                          "folder": folder, "out": str(root / "out"),
                          "options": MESH_2X2, "resume": os.path.join(
                              jax_folder, "checkpoint_00000.pt")})
    return dict(jax_losses=jax_losses, jax_mrr=jax_mrr,
                jax_folder=jax_folder, folder=folder, results=results)


def test_fused_negsamp_mesh_matches_kge_tpu_mesh(fused_runs):
    port = fused_runs["results"][0]
    np.testing.assert_allclose([l for l, _ in port["losses"]],
                               fused_runs["jax_losses"], rtol=1e-5)
    np.testing.assert_allclose(port["valid"], fused_runs["jax_mrr"],
                               rtol=0, atol=1e-6)
    want = example_ranks(fused_runs["jax_folder"])
    assert want and example_ranks(fused_runs["folder"]) == want


def test_mesh_bookkeeping(fused_runs):
    """Every rank reports the same losses; rank 0 alone writes
    checkpoints, the others log to proc<i>/."""
    folder, results = fused_runs["folder"], fused_runs["results"]
    for rank, result in enumerate(results):
        assert result["losses"] == results[0]["losses"]
        assert result["valid"] == results[0]["valid"]
        assert result["log_folder"] == (
            None if rank == 0 else os.path.join(folder, f"proc{rank}"))
        if rank:
            names = os.listdir(os.path.join(folder, f"proc{rank}"))
            assert "kge.log" in names
            assert not [n for n in names if n.startswith("checkpoint")]
    assert {"checkpoint_00001.pt", "checkpoint_best.pt"} <= set(
        os.listdir(folder))


@pytest.mark.parametrize("jax", [True, False], ids=["kge_tpu", "port"])
def test_mesh_checkpoint_evaluates_on_one_device(fused_runs, jax):
    """The 2x2 run's checkpoint (whole tables) loads on one device in
    either package and evaluates to the mesh run's MRR."""
    folder = fused_runs["folder"]
    mrr = eval_mrr(folder, os.path.join(folder, "checkpoint_best.pt"), jax)
    assert mrr == pytest.approx(fused_runs["results"][0]["valid"][-1],
                                abs=1e-6)


@pytest.mark.parametrize("train_type", ["KvsAll", "1vsAll"])
def test_label_scoring_mesh_matches_kge_tpu_mesh(tmp_path, train_type):
    """KvsAll and 1vsAll score against the table gathered over the model
    group: the first epoch's loss is kge_tpu's 2x2 mesh's."""
    config_file = write_config(tmp_path, {
        **NEGSAMP, "train": {**NEGSAMP["train"], "type": train_type,
                             "loss": "kl"},
        "valid": {**NEGSAMP["valid"], "every": 0}})
    jax_folder = str(tmp_path / "jax")
    want, _, _ = jax_run(config_file, MESH_2X2, jax_folder)
    results = run_job(4, {"config": config_file, "dataset": DATASET,
                          "out": str(tmp_path / "out"), "options": MESH_2X2,
                          "resume": os.path.join(jax_folder,
                                                 "checkpoint_00000.pt")})
    np.testing.assert_allclose(results[0]["losses"][0][0], want[0],
                               rtol=1e-5)


def test_conve_on_a_data_axis_matches_one_process(tmp_path):
    """Reciprocal ConvE by KvsAll with dropout on a 2x1 mesh: the masks
    are the global batch's, the batch-norm statistics the global
    batch's (summed over the data group), so losses and the running
    statistics are one process's."""
    config = {
        **NEGSAMP, "model": "reciprocal_relations_model",
        "reciprocal_relations_model": {"base_model": {"type": "conve"}},
        "conve": {"round_dim": True, "entity_embedder": {"dim": 33},
                  "relation_embedder": {"dim": 33},
                  "feature_map_dropout": 0.2, "projection_dropout": 0.3},
        # plain SGD: Adagrad's and Adam's first steps are near g/|g|,
        # which blows float noise in the gradients of the biases before
        # a batch norm (zero in exact arithmetic) up to whole steps
        "train": {**NEGSAMP["train"], "type": "KvsAll", "max_epochs": 2,
                  "loss": "kl", "optimizer": {"default": {
                      "type": "sgd", "args": {"lr": 0.01}}}},
        "valid": {**NEGSAMP["valid"], "every": 0}}
    config_file = write_config(tmp_path, config)
    want_losses, _, job = single_process(config_file, {})
    want_state = job.model.state()
    results = run_job(2, {"config": config_file, "dataset": DATASET,
                          "out": str(tmp_path / "out"),
                          "options": {"tpu.mesh.data": 2}})
    np.testing.assert_allclose(results[0]["losses"], want_losses, rtol=1e-5)
    for name, stats in want_state.items():
        for key, value in stats.items():
            np.testing.assert_allclose(results[0]["state"][name][key], value,
                                       rtol=1e-5, atol=1e-5)


def test_kge_tpu_checkpoint_resumes_under_a_port_mesh(tmp_path):
    """A kge_tpu single-device checkpoint resumes on the port's 2x2
    mesh, and the epoch after it is kge_tpu's uninterrupted one."""
    config_file = write_config(tmp_path, {
        **NEGSAMP, "train": {**NEGSAMP["train"], "max_epochs": 2},
        "valid": {**NEGSAMP["valid"], "every": 0},
        "tpu": {**NEGSAMP["tpu"], "fused_negsamp_loss": "never"}})
    jax_folder = str(tmp_path / "jax")
    want, _, _ = jax_run(config_file, {"train.checkpoint.every": 1},
                         jax_folder)
    results = run_job(4, {
        "config": config_file, "dataset": DATASET,
        "out": str(tmp_path / "out"), "options": MESH_2X2,
        "resume": os.path.join(jax_folder, "checkpoint_00001.pt")})
    assert len(results[0]["losses"]) == 1
    np.testing.assert_allclose(results[0]["losses"][0][0], want[1],
                               rtol=1e-5)


def test_folders_must_agree_across_ranks(tmp_path):
    config_file = write_config(tmp_path, NEGSAMP)
    spec = {"config": config_file, "dataset": DATASET,
            "folder": str(tmp_path / "run"), "folder_on_rank0_only": True,
            "out": str(tmp_path / "out"), "options": {"tpu.mesh.data": 2}}
    rcs, outs = launch(2, ["-m", "tests.torch_mesh_launch", "train",
                           json.dumps(spec)])
    for rc, out in zip(rcs, outs):
        assert rc != 0
        assert "must set a folder on every process or on none" in out


def test_unseeded_mesh_agrees_across_ranks(tmp_path):
    """Without seeds every rank takes rank 0's: the replicated tables of
    a 2x1 mesh stay equal across ranks."""
    config = {**NEGSAMP, "random_seed": {"default": -1}}
    config_file = write_config(tmp_path, config)
    results = run_job(2, {"config": config_file, "dataset": DATASET,
                          "out": str(tmp_path / "out"),
                          "options": {"tpu.mesh.data": 2}})
    assert results[0]["param_sums"] == results[1]["param_sums"]
    assert results[0]["losses"] == results[1]["losses"]
