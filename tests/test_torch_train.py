"""The port's negative-sampling trainer (kge_tpu_torch/train) against
kge_tpu's on data/toy: ComplEx dim 16, batch 32, two epochs, the same
seed, and the JAX job's initial weights carried into the port.

Tolerances. The first step's loss sees identical weights: rtol 1e-6. Per
epoch avg_loss: rtol 1e-5. The final tables: atol 1e-4 (rtol 1e-4),
because Adagrad's first update of an element is lr * g / (|g| + eps),
about lr * sign(g): a gradient element at rounding-noise size in one
framework's summation order can have the other sign in the other's and
move the element by 2 * lr. With ``initial_accumulator_value`` 0.1 that
update is smooth in g, and the tables agree to atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.parallel import mesh as mesh_lib
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.io import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)
TOY = os.path.join(REPO, "data", "toy")

OPTIONS = {
    "job.type": "train", "job.device": "cpu", "console.quiet": True,
    "random_seed.default": 3, "lookup_embedder.dim": 16,
    "train.type": "negative_sampling", "train.loss": "kl",
    "train.max_epochs": 2, "train.batch_size": 32,
    "train.optimizer.default.args.lr": 0.2,
    "negative_sampling.num_samples.s": 7,
    "negative_sampling.num_samples.o": 7,
    "negative_sampling.shared": True,
    "negative_sampling.implementation": "batch",
    "valid.every": 0,
    # kge_tpu samples on the host and dispatches one step per batch
    "tpu.on_device_sampling": "never", "tpu.steps_per_dispatch": 1,
}
TABLE_TOL = dict(rtol=1e-4, atol=1e-4)


def make_config(cls, options, folder=None):
    config = cls(folder=folder)
    config.set("model", "complex")
    config._import("complex")
    for key, value in {**OPTIONS, **options}.items():
        config.set(key, value, create=True)
    if folder:
        config.init_folder()
    return config


def jax_job(options, folder=None):
    config = make_config(JaxConfig, options, folder)
    return JaxTrainingJob.create(config, JaxDataset.create(config, TOY))


def port_job(options, folder=None, params=None):
    config = make_config(Config, options, folder)
    job = TrainingJob.create(config, Dataset.create(config, TOY))
    if params is not None:
        job.model.load_params(params)
    return job


def record_epochs(job):
    """Each epoch's (avg_loss, avg_cost); the cost adds the penalty."""
    losses = []
    job.post_epoch_hooks.append(lambda j: losses.append(
        [j.current_trace["epoch"][k] for k in ("avg_loss", "avg_cost")]))
    return losses


def jax_tables(job):
    return {k: np.asarray(v["weights"]) for k, v in job.params.items()
            if "weights" in v}


def port_tables(job):
    return {k: v["weights"] for k, v in job.model.params().items()
            if "weights" in v}


def assert_tables_close(a, b, **tol):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], err_msg=key, **tol)


def first_batch_loss(folder):
    with open(os.path.join(folder, "trace.yaml")) as f:
        for line in f:
            entry = yaml.safe_load(line)
            if entry.get("scope") == "batch":
                return entry["avg_loss"]
    raise AssertionError("no batch entry in trace.yaml")


CASES = {
    "unfused-default-wr": {"tpu.fused_negsamp_loss": "never"},
    "fused-default-wr": {"tpu.fused_negsamp_loss": "always"},
    "fused-naive-wr": {"tpu.fused_negsamp_loss": "always",
                       "negative_sampling.shared_type": "naive"},
    "fused-default-wor": {"tpu.fused_negsamp_loss": "always",
                          "negative_sampling.with_replacement": False},
    "unfused-naive-wor": {"tpu.fused_negsamp_loss": "never",
                          "negative_sampling.shared_type": "naive",
                          "negative_sampling.with_replacement": False},
    "not-shared-batch": {"negative_sampling.shared": False},
    "fused-accumulator": {
        "tpu.fused_negsamp_loss": "always",
        "train.optimizer.default.args.initial_accumulator_value": 0.1},
    "unfused-lp-penalty": {"tpu.fused_negsamp_loss": "never",
                           "lookup_embedder.regularize_weight": 0.01},
    "fused-weighted-penalty": {
        "tpu.fused_negsamp_loss": "always",
        "lookup_embedder.regularize_weight": 0.01,
        "lookup_embedder.regularize_args.weighted": True},
    "fused-normalized": {"tpu.fused_negsamp_loss": "always",
                         "lookup_embedder.normalize.p": 2.0},
}


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_kge_tpu(name, tmp_path):
    options = {**CASES[name], "train.trace_level": "batch"}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(
        options, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    fused = name.startswith("fused-")
    assert port_run._fused_slots == ((0, 2) if fused else ())
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tol = (dict(rtol=1e-6, atol=1e-6) if name == "fused-accumulator"
           else TABLE_TOL)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run), **tol)


def test_subbatch_invariance():
    """Forward-only loss with and without subbatches (tests/test_train.py
    test_subbatch_invariance)."""
    losses = []
    for subbatch in (-1, 7):
        job = port_job({"train.subbatch_size": subbatch,
                        "tpu.fused_negsamp_loss": "always"},
                       )
        job = TrainingJob.create(job.config, job.dataset, forward_only=True)
        job._prepare()
        job._is_prepared = True
        job.epoch = 1
        losses.append(job.run_epoch()["avg_loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_subbatches_train_like_whole_batches():
    """Gradient accumulation over subbatches gives the whole batch's
    update (up to summation order)."""
    tables = []
    for subbatch in (-1, 10):
        job = port_job({"train.subbatch_size": subbatch,
                        "train.max_epochs": 1})
        job.run()
        tables.append(port_tables(job))
    assert_tables_close(tables[0], tables[1], rtol=1e-5, atol=1e-6)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    options = {"tpu.fused_negsamp_loss": "always",
               "train.checkpoint.every": 1}
    full = port_job(options, str(tmp_path / "full"))
    full.run()
    cut = port_job({**options, "train.max_epochs": 1},
                   str(tmp_path / "cut"))
    cut.run()
    checkpoint = load_checkpoint(cut.config.checkpoint_file(1))
    resumed = Job.create_from(checkpoint, dataset=cut.dataset)
    assert resumed.epoch == 1
    resumed.config.set("train.max_epochs", 2)
    resumed.run()
    assert resumed.epoch == 2
    a, b = port_tables(full), port_tables(resumed)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(
        full.opt_state["sum"]["entity_embedder.weights"].numpy(),
        resumed.opt_state["sum"]["entity_embedder.weights"].numpy())


def _resume_both(checkpoint_file, jax_dataset, port_dataset):
    """kge_tpu and the port each resume ``checkpoint_file`` for one
    epoch (without a folder); returns (jax job, port job) after it."""
    jax_checkpoint = jax_load_checkpoint(checkpoint_file)
    jax_checkpoint.pop("folder")
    jax_run = JaxJob.create_from(jax_checkpoint, dataset=jax_dataset)
    port_checkpoint = load_checkpoint(checkpoint_file)
    port_checkpoint.pop("folder")
    port_run = Job.create_from(port_checkpoint, dataset=port_dataset)
    # kge_tpu takes the stored PRNG key as it is (and splits it per epoch)
    np.testing.assert_array_equal(np.asarray(jax_run.rng),
                                  jax_checkpoint["rng"])
    losses = []
    for job in (jax_run, port_run):
        assert job.epoch == 1
        job.config.set("train.max_epochs", 2)
        losses.append(record_epochs(job))
        job.run()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    return jax_run, port_run


def test_checkpoints_cross_over(tmp_path):
    options = {"tpu.fused_negsamp_loss": "always", "train.max_epochs": 1}
    # kge_tpu's checkpoint after epoch 1, resumed by both
    jax_run = jax_job(options, str(tmp_path / "jax"))
    jax_run.run()
    jax_file = jax_run.config.checkpoint_file(1)
    j, p = _resume_both(jax_file, jax_run.dataset,
                        Dataset.create(make_config(Config, options), TOY))
    assert_tables_close(port_tables(p), jax_tables(j), **TABLE_TOL)
    # the port's checkpoint after epoch 1, resumed by both
    port_run = port_job(options, str(tmp_path / "port"))
    port_run.run()
    port_file = port_run.config.checkpoint_file(1)
    with open(port_file, "rb") as f:
        assert b"kge_tpu_torch" not in f.read()
    j, p = _resume_both(port_file, jax_run.dataset, port_run.dataset)
    assert_tables_close(port_tables(p), jax_tables(j), **TABLE_TOL)
    assert jax_load_checkpoint(port_file)["rng"].dtype == np.uint32


def _ids(options):
    return "-".join(f"{k.split('.')[-1]}={v}" for k, v in options.items())


@pytest.mark.parametrize("options", [
    {"tpu.mesh.data": 2},
], ids=_ids)
def test_unported_modes_raise(options):
    """Nothing raises "not yet ported" any more: an R-GNN encoder under
    the options' mesh, as a training job of it makes the mesh active,
    builds (a data axis alone: every layer on the gathered route, as
    tests/test_torch_rgnn_mesh.py trains it)."""
    config = Config()
    config.load(os.path.join(REPO, "examples", "toy-rgcn-train.yaml"),
                create=True)
    for key, value in {**options, "job.device": "cpu"}.items():
        config.set(key, value)
    mesh_lib.set_active(mesh_lib.Mesh(config.get("tpu.mesh.data"),
                                      config.get("tpu.mesh.model"), 0))
    try:
        model = KgeModel.create(config, Dataset.create(config, TOY),
                                device=torch.device("cpu"),
                                generator=torch.Generator().manual_seed(0))
    finally:
        mesh_lib.set_active(None)
    assert "halo" not in model.encoder.graph()


@pytest.mark.parametrize("options", [
    {"tpu.sparse_updates": "always",
     "negative_sampling.implementation": "triple",
     "negative_sampling.shared": False,
     "lookup_embedder.regularize_args.weighted": True},
    {"train.loss": "bce"},
    {"train.optimizer.default.type": "Adam"},
    {"negative_sampling.implementation": "triple"},
    {"train.type": "KvsAll"},
    {"train.type": "1vsAll"},
    {"lookup_embedder.dropout": 0.1},
    {"tpu.compute_dtype": "bfloat16"},
    {"eval.type": "training_loss", "valid.every": 1},
    {"tpu.on_device_sampling": "always", "tpu.fused_negsamp_loss": "always",
     "tpu.steps_per_dispatch": 4},
    {"tpu.prefetch_batches": 2},
], ids=_ids)
def test_formerly_unported_modes_train(options):
    """The modes this test file once listed as raising train an epoch
    (tests/test_torch_kvsall.py and tests/test_torch_negsamp_modes.py hold
    them against kge_tpu)."""
    job = port_job({**options, "train.max_epochs": 1})
    result = job.run()
    assert result["epoch"] == 1 and np.isfinite(result["avg_loss"])


def test_fused_loss_auto_is_off_on_the_cpu():
    job = port_job({"tpu.fused_negsamp_loss": "auto"})
    job._prepare()
    assert job._fused_slots == ()
    with pytest.raises(ValueError, match="not applicable"):
        port_job({"tpu.fused_negsamp_loss": "always",
                  "negative_sampling.shared": False})._prepare()
