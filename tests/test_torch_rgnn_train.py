"""Training the R-GNN models in the port against kge_tpu on data/toy at
dropout 0 (the torch and JAX PRNG streams draw different masks): the
same seed, the JAX job's initial weights carried into the port, two
epochs. Tolerances as for every trainer (tests/test_torch_train.py): the
first step's loss rtol 1e-6, each epoch's avg_loss rtol 1e-5.

- CompGCN with a reciprocal ConvE decoder by KvsAll with bce, label
  smoothing and Adam (the main path of chip_smoke.py, ccorr and edge
  norm, cut to the toy size), the encoder's and ConvE's batch-norm
  state through every step;
- R-GCN (block weights) with DistMult by bce negative sampling over an
  edge-neighbourhood subgraph each epoch (the R-GCN recipe's sampler,
  the subgraph the encoder's graph);
- W-GCN with a reciprocal ConvE decoder by KvsAll (its relations the
  decoder's embedder's); RAGAT with DistMult by 1vsAll; CompGCN with
  TransE by margin ranking (the toy-transe-compgcn example's training).

Checkpoints of each of them cross between the packages both ways with
their model state and Adam's ``opt_state``; ``tpu.sparse_updates: always``
is refused for an R-GNN model with kge_tpu's reason; the four toy R-GNN
examples train and validate through the port's CLI.
"""

import os

import jax
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset, cli
from kge_tpu_torch.train.train import TrainingJob
from tests.test_torch_train import (
    TABLE_TOL, TOY, _resume_both, assert_tables_close, first_batch_loss,
    record_epochs,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {
    "job.type": "train", "job.device": "cpu", "console.quiet": True,
    "random_seed.default": 3, "train.max_epochs": 2,
    "train.batch_size": 32, "valid.every": 0,
    "tpu.on_device_sampling": "never", "tpu.steps_per_dispatch": 1,
    "train.trace_level": "batch",
}
ADAM = {"train.optimizer.default.type": "Adam",
        "train.optimizer.default.args.lr": 0.003}


def encoder(preset, dim=8, **options):
    """The preset at dim ``dim`` with every dropout 0."""
    out = {f"{preset}.entity_embedder.dim": dim,
           f"{preset}.relation_embedder.dim": dim,
           f"{preset}.encoder.edge_dropout": 0.0,
           f"{preset}.encoder.self_edge_dropout": 0.0,
           f"{preset}.encoder.emb_entity_dropout": 0.0,
           f"{preset}.encoder.message_passing_args.emb_propagation_dropout":
               0.0}
    out.update({f"{preset}.{k}": v for k, v in options.items()})
    return out


def reciprocal_conve(preset, dim=8):
    base = f"{preset}.decoder.base_model."
    return {base + "entity_embedder.dim": dim,
            base + "relation_embedder.dim": dim,
            base + "feature_map_dropout": 0.0,
            base + "projection_dropout": 0.0,
            base + "entity_embedder.dropout": 0.0,
            base + "relation_embedder.dropout": 0.0}


def bare(preset, decoder):
    return {f"{preset}.decoder.model": decoder,
            f"{preset}.decoder.type": decoder}


#: name -> (preset, options)
CASES = {
    "compgcn-conve-kvsall": ("compgcn", {
        **encoder("compgcn", **{
            "encoder.num_layers": 1, "encoder.activation": "tanh",
            "encoder.message_passing_args.composition": "ccorr"}),
        **reciprocal_conve("compgcn"), "train.type": "KvsAll",
        "train.loss": "bce", "KvsAll.label_smoothing": 0.1, **ADAM}),
    "rgcn-distmult-graph-sampling": ("rgcn", {
        **encoder("rgcn", dim=16, **{"encoder.num_blocks_or_bases": 4}),
        **bare("rgcn", "distmult"), "train.type": "negative_sampling",
        "train.loss": "bce", "train.batch_size": 100,
        "negative_sampling.graph_sampling": "edge_neighbourhood",
        "negative_sampling.graph_sampling_size": 200,
        "negative_sampling.num_samples.s": 5,
        "negative_sampling.num_samples.o": 5, **ADAM}),
    # rel_transformation self: the relations are the ConvE decoder's own
    # embedder's (its dropout 0 here)
    "wgcn-conve-kvsall": ("wgcn", {
        **encoder("wgcn"), **reciprocal_conve("wgcn"),
        "train.type": "KvsAll", "train.loss": "bce", **ADAM}),
    "ragat-distmult-1vsall": ("ragat", {
        **encoder("ragat"), **bare("ragat", "distmult"),
        "train.type": "1vsAll", **ADAM}),
    "compgcn-transe-margin": ("compgcn", {
        **encoder("compgcn", **{"encoder.num_layers": 2,
                                "encoder.activation": "tanh"}),
        **bare("compgcn", "transe"), "train.type": "negative_sampling",
        "train.loss": "margin_ranking", "train.loss_arg": 4.0,
        "negative_sampling.num_samples.s": 8,
        "negative_sampling.num_samples.o": 8, **ADAM}),
}


def make_config(cls, preset, options, folder=None):
    config = cls(folder=folder)
    config.set("model", preset)
    config._import(preset)
    for key, value in {**BASE, **options}.items():
        config.set(key, value, create=True)
    if folder:
        config.init_folder()
    return config


def jobs(name, tmp_path, **overrides):
    """(kge_tpu job, port job carrying its initial weights)."""
    preset, options = CASES[name]
    options = {**options, **overrides}
    jconfig = make_config(JaxConfig, preset, options, str(tmp_path / "jax"))
    jax_run = JaxTrainingJob.create(jconfig, JaxDataset.create(jconfig, TOY))
    pconfig = make_config(Config, preset, options, str(tmp_path / "port"))
    port_run = TrainingJob.create(pconfig, Dataset.create(pconfig, TOY))
    port_run.model.load_params(
        jax.tree_util.tree_map(np.asarray, jax_run.params))
    return jax_run, port_run


def assert_bn_state_close(got, want, steps):
    """Batch-norm statistics of two runs: the variances within rtol 1e-3;
    the means within 2 * lr * steps (they follow biases whose gradients
    are rounding noise, which Adam's first updates turn into lr-sized
    steps either way: the sign trap of PERF.md section 2)."""
    lr = ADAM["train.optimizer.default.args.lr"]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key]["var"],
                                   np.asarray(want[key]["var"]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got[key]["mean"],
                                   np.asarray(want[key]["mean"]),
                                   rtol=0, atol=2 * lr * steps, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_kge_tpu(name, tmp_path):
    jax_run, port_run = jobs(name, tmp_path)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if name == "compgcn-conve-kvsall":
        steps = 2 * port_run.current_trace["epoch"]["batches"]
        assert set(port_run.model.state()) == {
            "bn1", "bn2", "compgcn.encoder.layer0_bn"}
        assert_bn_state_close(port_run.model.state(), jax_run.model_state,
                              steps)
    if name == "rgcn-distmult-graph-sampling":
        # the encoder ran over the last epoch's subgraph: 200 triples
        assert port_run.model.encoder.graph()["edge_index"].shape == (2, 400)
        np.testing.assert_array_equal(
            port_run.model.encoder.graph()["edge_index"].numpy(),
            np.asarray(jax_run.model.get_rgnn_encoder()._graph_np[
                "edge_index"]))


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoints_cross_over_with_state(name, tmp_path):
    """A checkpoint after epoch 1, written by either package, resumes in
    both for one more epoch on the same trajectory (epoch losses rtol
    1e-5, tables ``TABLE_TOL``): the encoder's layers as a list, the
    batch-norm state of the encoder and of ConvE, Adam's ``opt_state`` by
    leaf order."""
    jax_run, port_run = jobs(name, tmp_path, **{"train.max_epochs": 1})
    jax_run.run()
    port_run.run()
    want_state = set(jax_run.model.init_state())
    assert set(port_run.model.state()) == want_state
    for run in (jax_run, port_run):
        checkpoint_file = run.config.checkpoint_file(1)
        stored = jax_load_checkpoint(checkpoint_file)
        assert set(stored["model"]["state"]) == want_state
        assert isinstance(stored["model"]["params"]["encoder"]["layers"],
                          list)
        j, p = _resume_both(checkpoint_file, jax_run.dataset,
                            port_run.dataset)
        tables = {k: np.asarray(v["weights"])
                  for k, v in j.params.items() if "weights" in v}
        assert_tables_close(
            {k: v["weights"] for k, v in p.model.params().items()
             if "weights" in v}, tables, **TABLE_TOL)
        assert (jax.tree_util.tree_structure(p.model.params())
                == jax.tree_util.tree_structure(
                    jax.tree_util.tree_map(np.asarray, j.params)))
        assert_bn_state_close(p.model.state(), j.model_state,
                              p.current_trace["epoch"]["batches"])


def test_sparse_always_refused_for_a_gnn_model():
    """``tpu.sparse_updates: always`` raises for an R-GNN model with
    kge_tpu's reasons (the encoder reads every row)."""
    preset, options = CASES["compgcn-transe-margin"]
    options = {**options, "tpu.sparse_updates": "always"}
    errors = []
    for cls, dataset_cls, job_cls in (
            (JaxConfig, JaxDataset, JaxTrainingJob),
            (Config, Dataset, TrainingJob)):
        config = make_config(cls, preset, options)
        with pytest.raises(ValueError, match="not applicable") as info:
            job_cls.create(config, dataset_cls.create(config, TOY))
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "GNN encoder runs over the full graph" in errors[1]


@pytest.mark.parametrize("example", ["rgcn", "wgcn", "ragat",
                                     "transe-compgcn"])
def test_toy_examples_train_and_validate(example, tmp_path):
    """``python -m kge_tpu_torch start examples/toy-<example>-train.yaml
    --job.device cpu --train.max_epochs 2 --valid.every 1``: two epochs
    with finite losses, a validation after each, the ignored TPU layout
    logged once."""
    folder = str(tmp_path / example)
    result = cli.main([
        "start", os.path.join(REPO, "examples", f"toy-{example}-train.yaml"),
        "--folder", folder, "--job.device", "cpu", "--train.max_epochs",
        "2", "--valid.every", "1", "--console.quiet", "true"])
    assert result["epoch"] == 2 and np.isfinite(result["avg_loss"])
    with open(os.path.join(folder, "kge.log")) as f:
        log = f.read()
    assert log.count("neighbor_block_size 16 is ignored") == 1
    assert log.count("mean_reciprocal_rank_filtered") >= 2
