"""Training the new scorers in the port against kge_tpu on data/toy, at
dropout 0 (the torch and JAX PRNG streams draw different masks): the
same seed, the JAX job's initial weights carried into the port, two
epochs. Tolerances as for every trainer (tests/test_torch_train.py): the
first step's loss rtol 1e-6, each epoch's avg_loss rtol 1e-5.

- reciprocal ConvE by KvsAll with bce, label smoothing and Adam (the
  main path of chip_smoke.py, cut to the toy size), batch-norm state
  carried through every step;
- RotatE by bce_self_adversarial with shared negatives (the
  toy-rotate example's training);
- TransE by margin_ranking with ``triple`` scoring (toy-transe's);
- DistMult by shared ``kl`` through the fused loss's plain version;
- RelationalTucker3 by 1vsAll (toy-rt3's);
- reciprocal Transformer by 1vsAll with three layers.

Checkpoints of reciprocal ConvE with Adam and of the Transformer cross
between the packages both ways with their model state and ``opt_state``;
a dropout run resumed draws the uninterrupted run's masks.
"""

import jax
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_train import (
    TABLE_TOL, TOY, _resume_both, assert_tables_close, first_batch_loss,
    record_epochs,
)

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

BASE = {
    "job.type": "train", "job.device": "cpu", "console.quiet": True,
    "random_seed.default": 3, "train.max_epochs": 2,
    "train.batch_size": 32, "valid.every": 0, "lookup_embedder.dim": 16,
    "tpu.on_device_sampling": "never", "tpu.steps_per_dispatch": 1,
    "train.trace_level": "batch",
}
ADAM = {"train.optimizer.default.type": "Adam",
        "train.optimizer.default.args.lr": 0.003}
NO_CONVE_DROPOUT = {"conve.feature_map_dropout": 0.0,
                    "conve.projection_dropout": 0.0,
                    "conve.entity_embedder.dropout": 0.0,
                    "conve.relation_embedder.dropout": 0.0}
SMALL_TRANSFORMER = {"transformer.encoder.nhead": 2,
                     "transformer.encoder.dim_feedforward": 24,
                     "transformer.encoder.num_layers": 3,
                     "transformer.encoder.dropout": 0.0}

#: name -> (model, reciprocal?, options)
CASES = {
    "reciprocal-conve-kvsall-adam": (
        "conve", True, {"train.type": "KvsAll", "train.loss": "bce",
                        "KvsAll.label_smoothing": 0.1,
                        "lookup_embedder.dim": 8, **ADAM,
                        **NO_CONVE_DROPOUT}),
    "rotate-self-adversarial": (
        "rotate", False, {"train.type": "negative_sampling",
                          "train.loss": "bce_self_adversarial",
                          "negative_sampling.num_samples.s": 16,
                          "negative_sampling.num_samples.o": 16,
                          "negative_sampling.shared": True,
                          "lookup_embedder.initialize": "xavier_uniform_",
                          **ADAM}),
    "transe-margin-triple": (
        "transe", False, {"train.type": "negative_sampling",
                          "train.loss": "margin_ranking",
                          "train.loss_arg": 4.0,
                          "negative_sampling.num_samples.s": 8,
                          "negative_sampling.num_samples.o": 8,
                          "train.optimizer.default.args.lr": 0.1}),
    "distmult-shared-kl-fused": (
        "distmult", False, {"train.type": "negative_sampling",
                            "train.loss": "kl",
                            "negative_sampling.num_samples.s": 7,
                            "negative_sampling.num_samples.o": 7,
                            "negative_sampling.shared": True,
                            "negative_sampling.implementation": "batch",
                            "tpu.fused_negsamp_loss": "always",
                            "train.optimizer.default.args.lr": 0.2}),
    "relational-tucker3-1vsall": (
        "relational_tucker3", False, {"train.type": "1vsAll",
                                      "lookup_embedder.dim": 6, **ADAM}),
    "reciprocal-transformer-1vsall": (
        "transformer", True, {"train.type": "1vsAll", **ADAM,
                              **SMALL_TRANSFORMER}),
}


def assert_conve_state_close(got, want, steps):
    """The batch-norm statistics of two runs: the variances within rtol
    1e-3 (the tables agree to ``TABLE_TOL``); the means within 2 * lr *
    steps. ``bn1``'s mean follows the conv bias and ``bn2``'s the
    projection bias, whose gradients are zero up to rounding (the batch
    norm after each removes it), so Adam moves each bias by about
    lr * sign(rounding noise) a step, in either package its own way (the
    sign trap of PERF.md section 2), and a running mean averages those
    moves."""
    lr = ADAM["train.optimizer.default.args.lr"]
    for key in ("bn1", "bn2"):
        np.testing.assert_allclose(got[key]["var"],
                                   np.asarray(want[key]["var"]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got[key]["mean"],
                                   np.asarray(want[key]["mean"]),
                                   rtol=0, atol=2 * lr * steps, err_msg=key)


def make_config(cls, model, reciprocal, options, folder=None):
    config = cls(folder=folder)
    if reciprocal:
        config.set("model", "reciprocal_relations_model")
        config._import("reciprocal_relations_model")
        config.set("reciprocal_relations_model.base_model.type", model)
    else:
        config.set("model", model)
    config._import(model)
    for key, value in {**BASE, **options}.items():
        config.set(key, value, create=True)
    if folder:
        config.init_folder()
    return config


def jobs(name, tmp_path, **overrides):
    """(kge_tpu job, port job carrying its initial weights)."""
    model, reciprocal, options = CASES[name]
    options = {**options, **overrides}
    jconfig = make_config(JaxConfig, model, reciprocal, options,
                          str(tmp_path / "jax"))
    jax_run = JaxTrainingJob.create(jconfig, JaxDataset.create(jconfig, TOY))
    pconfig = make_config(Config, model, reciprocal, options,
                          str(tmp_path / "port"))
    port_run = TrainingJob.create(pconfig, Dataset.create(pconfig, TOY))
    port_run.model.load_params(
        jax.tree_util.tree_map(np.asarray, jax_run.params))
    return jax_run, port_run


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
    if name == "distmult-shared-kl-fused":
        assert port_run._fused_slots == (0, 2)
    if name == "transe-margin-triple":
        # TransE's prepare_job turns implementation auto into triple
        assert port_run.config.get(
            "negative_sampling.implementation") == "triple"
    if name.startswith("reciprocal-conve"):
        # the batch-norm statistics went through every step
        steps = 2 * port_run.current_trace["epoch"]["batches"]
        assert_conve_state_close(port_run.model.state(),
                                 jax_run.model_state, steps)
        assert not np.allclose(port_run.model.state()["bn2"]["var"], 1.0)


@pytest.mark.parametrize("name", ["reciprocal-conve-kvsall-adam",
                                  "reciprocal-transformer-1vsall"])
def test_checkpoints_cross_over_with_state(name, tmp_path):
    """A checkpoint after epoch 1, written by either package, resumes in
    both for one more epoch on the same trajectory (epoch losses rtol
    1e-5, tables ``TABLE_TOL``); the port reads the model state and
    ``opt_state`` (Adam's count, mu and nu, the Transformer's list of
    layers in index order) and writes them back in kge_tpu's layout."""
    jax_run, port_run = jobs(name, tmp_path, **{"train.max_epochs": 1})
    jax_run.run()
    port_run.run()
    for run in (jax_run, port_run):
        checkpoint_file = run.config.checkpoint_file(1)
        stored = jax_load_checkpoint(checkpoint_file)
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
        state = stored["model"]["state"]
        if name.startswith("reciprocal-conve"):
            assert set(state) == {"bn1", "bn2"}
            assert_conve_state_close(p.model.state(), j.model_state,
                                     p.current_trace["epoch"]["batches"])
        else:
            assert state == {}
            assert isinstance(p.model.params()["scorer"]["layers"], list)
            assert len(p.model.params()["scorer"]["layers"]) == 3
        assert [int(c) for c in p.opt_state["count"].values()] == [
            2 * int(np.asarray(c)) for c in
            jax.tree_util.tree_leaves(stored["opt_state"])
            if np.asarray(c).dtype == np.int32]


def test_dropout_resume_draws_the_same_masks(tmp_path):
    """Reciprocal ConvE with its default dropout (0.2 on both embedders,
    0.2 feature maps, 0.3 projection): a run resumed after epoch 1 equals
    the uninterrupted run (the masks' stream is seeded by the epoch), and
    dropout changes the losses."""
    model, reciprocal, options = CASES["reciprocal-conve-kvsall-adam"]
    dropout = {k: v for k, v in options.items()
               if k not in NO_CONVE_DROPOUT}
    losses = {}
    for label, opts in (("full", dropout), ("cut", dropout),
                        ("no-dropout", options)):
        config = make_config(Config, model, reciprocal, {
            **opts, "train.max_epochs": 1 if label == "cut" else 2,
            "train.checkpoint.every": 1}, str(tmp_path / label))
        job = TrainingJob.create(config, Dataset.create(config, TOY))
        losses[label] = record_epochs(job)
        job.run()
        if label == "full":
            full = job
        if label == "cut":
            resumed = Job.create_from(
                load_checkpoint(config.checkpoint_file(1)),
                dataset=job.dataset)
            resumed.config.set("train.max_epochs", 2)
            losses["resumed"] = record_epochs(resumed)
            resumed.run()
    assert losses["resumed"] == losses["full"][1:]
    a, b = full.model.params(), resumed.model.params()
    for mine, ref in zip(jax.tree_util.tree_leaves(a),
                         jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(mine, ref)
    for key in ("bn1", "bn2"):
        np.testing.assert_array_equal(full.model.state()[key]["var"],
                                      resumed.model.state()[key]["var"])
    assert not np.allclose(losses["full"], losses["no-dropout"], rtol=1e-3)


@pytest.mark.parametrize("model,reciprocal,options", [
    ("distmult", True, {}),
    ("transh", False, {}),
    ("rotate", False, {}),
    ("relational_tucker3", False, {"lookup_embedder.dim": 6}),
], ids=["reciprocal", "transh", "rotate", "relational_tucker3"])
def test_sparse_always_refused_with_kge_tpus_reasons(model, reciprocal,
                                                     options):
    """``tpu.sparse_updates: always`` refused for the new models with
    kge_tpu's reasons: the reciprocal rewrite of relation indices,
    TransH's whole-table penalties, RotatE's phase renormalization, a
    projection relation embedder."""
    options = {**options, "train.type": "negative_sampling",
               "tpu.sparse_updates": "always",
               "negative_sampling.num_samples.s": 3,
               "negative_sampling.num_samples.o": 3}
    errors = []
    for cls, dataset_cls, job_cls in (
            (JaxConfig, JaxDataset, JaxTrainingJob),
            (Config, Dataset, TrainingJob)):
        config = make_config(cls, model, reciprocal, options)
        with pytest.raises(ValueError, match="not applicable") as info:
            job_cls.create(config, dataset_cls.create(config, TOY))
        errors.append(str(info.value))
    assert errors[0] == errors[1]
