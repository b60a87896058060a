"""The port's CLI end to end on a checkpoint that kge_tpu trains: ``python
-m kge_tpu_torch test`` gives kge_tpu's metrics, loads the checkpoint
without importing kge_tpu, optax or jax, and a checkpoint the port writes
loads and evaluates in kge_tpu.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset, cli
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import load_checkpoint
from kge_tpu_torch.utils.misc import resolve_device
from tests.test_torch_train import (
    TABLE_TOL, TOY, assert_tables_close, jax_job, jax_tables, make_config,
    port_job, port_tables, record_epochs,
)
from tests.torch_mesh_launch import launch_ok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """A toy ComplEx run trained for one epoch by kge_tpu, in-process."""
    folder = str(tmp_path_factory.mktemp("kge-tpu") / "run")
    config = JaxConfig(folder=folder)
    config.load(os.path.join(REPO, "examples", "toy-complex-train.yaml"),
                create=True)
    for key, value in {
        "job.device": "cpu", "train.max_epochs": 1, "valid.every": 1,
        "lookup_embedder.dim": 16, "console.quiet": True,
        "random_seed.default": 3,
    }.items():
        config.set(key, value)
    config.init_folder()
    JaxJob.create(config, JaxDataset.create(config)).run()
    assert os.path.isfile(os.path.join(folder, "checkpoint_best.pt"))
    return folder


def jax_eval(checkpoint_file, folder):
    """kge_tpu's test-split evaluation of a checkpoint."""
    config = JaxConfig(folder=folder)
    config.load(os.path.join(folder, "config.yaml"), create=True)
    for key, value in {"job.type": "eval", "eval.split": "test",
                       "job.device": "cpu", "console.quiet": True}.items():
        config.set(key, value)
    job = JaxJob.create_from(jax_load_checkpoint(checkpoint_file),
                             new_config=config,
                             dataset=JaxDataset.create(config))
    job.verbose = False
    return job.run()


def _run(args, **kw):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=300, **kw)


def test_cli_test_prints_kge_tpu_metrics(jax_folder):
    r = _run(["-m", "kge_tpu_torch", "test", jax_folder,
              "--job.device", "cpu", "--console.quiet", "false"])
    assert r.returncode == 0, r.stderr[-3000:]
    printed = re.search(r"^\s*mean_reciprocal_rank_filtered: (\S+)$",
                        r.stdout, re.M)
    assert printed, r.stdout[-3000:]
    want = jax_eval(os.path.join(jax_folder, "checkpoint_best.pt"),
                    jax_folder)
    assert float(printed.group(1)) == pytest.approx(
        want["mean_reciprocal_rank_filtered"], rel=1e-12)


PORT_SCRIPT = """
import json, sys
import torch
from kge_tpu_torch import cli
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint

folder, out_file = sys.argv[1], sys.argv[2]
checkpoint = load_checkpoint(folder + "/checkpoint_best.pt")
model = KgeModel.create_from(checkpoint, device=torch.device("cpu"))
ids = torch.arange(4)
scores = model.score_sp(ids, ids % model.dataset.num_relations())
trace = cli.main(["test", folder, "--job.device", "cpu",
                  "--console.quiet", "true"])
mine = {"type": "train", "epoch": checkpoint["epoch"], "job_id": "port"}
model.save_to(mine)
model.config.save_to(mine)
model.dataset.save_to(mine)
save_checkpoint(out_file, mine)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print(json.dumps(dict(loaded=loaded, scores=scores.tolist(),
                      mrr=trace["mean_reciprocal_rank_filtered"])))
"""


def test_checkpoints_cross_without_importing_kge_tpu(jax_folder, tmp_path):
    out_file = str(tmp_path / "checkpoint_port.pt")
    r = _run(["-c", PORT_SCRIPT, jax_folder, out_file])
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []

    # the port's checkpoint loads in kge_tpu: same scores, same metrics
    checkpoint = jax_load_checkpoint(out_file)
    model, params, _ = JaxKgeModel.create_from(checkpoint)
    ids = np.arange(4)
    scores = model.score_sp(params, ids, ids % model.dataset.num_relations())
    np.testing.assert_allclose(np.asarray(scores), result["scores"],
                               rtol=1e-5, atol=1e-5)
    original = jax_eval(os.path.join(jax_folder, "checkpoint_best.pt"),
                        jax_folder)
    crossed = jax_eval(out_file, jax_folder)
    for key in ("mean_reciprocal_rank_filtered", "mean_rank", "hits_at_10"):
        assert crossed[key] == original[key], key
    assert result["mrr"] == pytest.approx(
        original["mean_reciprocal_rank_filtered"], rel=1e-12)


def test_device_auto_without_cuda_raises(jax_folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = Config()
    assert config.get("job.device") == "auto"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(config)
    for verb in ("test", "resume"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([verb, jax_folder, "--job.device", "auto"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["start", os.path.join(jax_folder, "config.yaml"),
                  "--folder", str(tmp_path / "run"), "--job.device", "auto"])
    config.set("job.device", "cuda:1")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(config)


def test_dump_config_and_unported_verbs(jax_folder, capsys, tmp_path):
    cli.main(["dump", "config", jax_folder, "--minimal"])
    out = capsys.readouterr().out
    assert "lookup_embedder.dim: 16" in out
    assert "kge_tpu." not in out
    # the toy example trains KvsAll with Adagrad: one epoch on the host
    folder = str(tmp_path / "kvsall")
    result = cli.main(["start", "examples/toy-complex-train.yaml",
                       "--folder", folder, "--job.device", "cpu",
                       "--train.max_epochs", "1", "--console.quiet", "true"])
    assert result["epoch"] == 1 and result["type"] == "KvsAll"
    assert np.isfinite(result["avg_loss"])
    assert os.path.isfile(os.path.join(folder, "checkpoint_00001.pt"))
    # every verb of kge_tpu is ported: package writes kge_tpu's model file
    packaged = str(tmp_path / "model.pt")
    cli.main(["package", os.path.join(jax_folder, "checkpoint_best.pt"),
              "--file", packaged])
    assert jax_load_checkpoint(packaged)["type"] == "package"


#: toy ComplEx trained by shared negative sampling with the kl loss
NEGSAMP_CONFIG = {
    "job": {"type": "train"},
    "dataset": {"name": "toy"},
    "model": "complex",
    "lookup_embedder": {"dim": 16},
    "train": {"type": "negative_sampling", "loss": "kl", "batch_size": 64,
              "optimizer": {"default": {"type": "Adagrad",
                                        "args": {"lr": 0.2}}}},
    "negative_sampling": {"num_samples": {"s": 7, "o": 7}, "shared": True,
                          "implementation": "batch"},
    "valid": {"metric": "mean_reciprocal_rank_filtered"},
    "eval": {"batch_size": 64},
    "random_seed": {"default": 3},
    "tpu": {"on_device_sampling": "never"},
}

TRAIN_SCRIPT = """
import json, sys
from kge_tpu_torch import cli

config_file, folder, sparse_folder = sys.argv[1:4]
cpu = ["--job.device", "cpu", "--console.quiet", "true"]
started = cli.main(["start", config_file, "--folder", folder,
                    "--train.max_epochs", "2", "--valid.every", "1", *cpu])
resumed = cli.main(["resume", folder, "--train.max_epochs", "3", *cpu])
tested = cli.main(["test", folder, *cpu])
sparse = ["--tpu.sparse_updates", "always"]
sparse_started = cli.main(["start", config_file, "--folder", sparse_folder,
                           "--train.max_epochs", "1", *sparse, *cpu])
sparse_resumed = cli.main(["resume", sparse_folder, "--train.max_epochs",
                           "2", *sparse, *cpu])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print(json.dumps(dict(loaded=loaded,
                      epochs=[started["epoch"], resumed["epoch"]],
                      sparse_epochs=[sparse_started["epoch"],
                                     sparse_resumed["epoch"]],
                      mrr=tested["mean_reciprocal_rank_filtered"])))
"""


def epoch_entries(folder):
    with open(os.path.join(folder, "trace.yaml")) as f:
        entries = [yaml.safe_load(line) for line in f]
    return [e for e in entries if e.get("event") == "epoch_completed"
            and e.get("job") == "train"]


def test_cli_trains_and_resumes_without_importing_kge_tpu(tmp_path):
    """start, resume and test of a negative-sampling run in a subprocess
    that loads no JAX module; kge_tpu evaluates the port's best
    checkpoint to the port's metric and writes the same epoch trace
    keys."""
    config_file = str(tmp_path / "toy-negsamp.yaml")
    with open(config_file, "w") as f:
        yaml.safe_dump(NEGSAMP_CONFIG, f)
    folder = str(tmp_path / "port-run")
    sparse_folder = str(tmp_path / "port-sparse-run")
    r = _run(["-c", TRAIN_SCRIPT, config_file, folder, sparse_folder],
             env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["epochs"] == [2, 3]
    assert result["sparse_epochs"] == [1, 2]
    with open(os.path.join(sparse_folder, "kge.log")) as f:
        assert f.read().count("Using row-sparse embedding updates.") == 2
    assert set(jax_load_checkpoint(os.path.join(
        sparse_folder, "checkpoint_00002.pt"))["opt_state"]) == {
            "sparse", "tx"}
    port_epochs = epoch_entries(folder)
    assert [e["epoch"] for e in port_epochs] == [1, 2, 3]
    assert all(np.isfinite(e["avg_loss"]) for e in port_epochs)

    want = jax_eval(os.path.join(folder, "checkpoint_best.pt"), folder)
    assert result["mrr"] == pytest.approx(
        want["mean_reciprocal_rank_filtered"], rel=1e-12)

    # kge_tpu's own run of the config traces the same epoch keys
    jax_folder = str(tmp_path / "jax-run")
    config = JaxConfig(folder=jax_folder)
    config.load(config_file, create=True)
    for key, value in {"job.device": "cpu", "train.max_epochs": 1,
                       "valid.every": 0, "console.quiet": True}.items():
        config.set(key, value)
    config.init_folder()
    JaxJob.create(config, JaxDataset.create(config)).run()
    (jax_epoch,) = epoch_entries(jax_folder)
    assert set(port_epochs[0]) == set(jax_epoch)


STRATEGY_SCRIPT = """
import json, sys
from kge_tpu_torch import cli

folder = sys.argv[1]
toy = "examples/toy-complex-train.yaml"
cpu = ["--job.device", "cpu", "--console.quiet", "true",
       "--valid.every", "1"]
dim = ["--lookup_embedder.dim", "16"]
runs = {
    "kvsall-adam": [*dim, "--train.loss", "bce",
                    "--KvsAll.label_smoothing", "0.1",
                    "--train.optimizer.default.type", "Adam",
                    "--train.optimizer.default.args.lr", "0.01"],
    "1vsall": [*dim, "--train.type", "1vsAll"],
    "triple": [*dim, "--train.type", "negative_sampling"],
    # reciprocal ConvE by KvsAll with Adam and its default dropout
    "conve": ["--conve.entity_embedder.dim", "32",
              "--conve.relation_embedder.dim", "32"],
    # an R-GNN encoder (CompGCN, batch-norm state) with a TransE decoder
    "compgcn": ["--compgcn.entity_embedder.dim", "16",
                "--compgcn.relation_embedder.dim", "16",
                "--compgcn.encoder.num_layers", "1"],
    # negatives drawn on the device, the epoch grouped 4 steps a dispatch
    "on-device": [*dim, "--train.type", "negative_sampling",
                  "--train.loss", "kl", "--negative_sampling.shared", "true",
                  "--negative_sampling.implementation", "batch",
                  "--tpu.fused_negsamp_loss", "always",
                  "--tpu.on_device_sampling", "always",
                  "--tpu.steps_per_dispatch", "4"],
}
examples = {"conve": "examples/toy-conve-train.yaml",
            "compgcn": "examples/toy-transe-compgcn-train.yaml"}
epochs = {}
for name, options in runs.items():
    run = folder + "/" + name
    started = cli.main(["start", examples.get(name, toy), "--folder", run,
                        "--train.max_epochs", "1", *options, *cpu])
    resumed = cli.main(["resume", run, "--train.max_epochs", "2", *cpu])
    epochs[name] = [started["epoch"], resumed["epoch"], resumed["type"]]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print(json.dumps(dict(loaded=loaded, epochs=epochs)))
"""


def test_cli_trains_every_strategy_without_importing_kge_tpu(tmp_path):
    """start and resume of a KvsAll run with bce and Adam, a 1vsAll run,
    a run of the default sampler (``triple`` scoring), reciprocal ConvE
    (examples/toy-conve-train.yaml: KvsAll, Adam, dropout, batch-norm
    state), CompGCN (examples/toy-transe-compgcn-train.yaml: an R-GNN
    encoder with its batch-norm state) and shared negative sampling with
    the negatives drawn on the device and 4 steps a dispatch, in a
    subprocess that loads no JAX module; kge_tpu resumes each port
    checkpoint."""
    folder = str(tmp_path / "runs")
    r = _run(["-c", STRATEGY_SCRIPT, folder],
             env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["epochs"] == {"kvsall-adam": [1, 2, "KvsAll"],
                                "1vsall": [1, 2, "1vsAll"],
                                "triple": [1, 2, "negative_sampling"],
                                "conve": [1, 2, "KvsAll"],
                                "compgcn": [1, 2, "negative_sampling"],
                                "on-device": [1, 2, "negative_sampling"]}
    with open(os.path.join(folder, "triple", "kge.log")) as f:
        assert "Preparing negative sampling with 'triple' scoring" in f.read()
    with open(os.path.join(folder, "on-device", "kge.log")) as f:
        assert "Sampling negatives on device" in f.read()
    for name in ("kvsall-adam", "1vsall", "triple", "conve", "compgcn",
                 "on-device"):
        checkpoint = jax_load_checkpoint(
            os.path.join(folder, name, "checkpoint_00002.pt"))
        if name == "conve":
            # the batch-norm statistics, updated in training
            state = checkpoint["model"]["state"]
            assert set(state) == {"bn1", "bn2"}
            assert not np.allclose(state["bn2"]["var"], 1.0)
        if name == "compgcn":
            state = checkpoint["model"]["state"]["compgcn.encoder.layer0_bn"]
            assert not np.allclose(state["var"], 1.0)
        checkpoint.pop("folder")
        config = JaxConfig.create_from(checkpoint)
        config.set("train.max_epochs", 3)
        config.set("job.device", "cpu")
        job = JaxJob.create_from(checkpoint, new_config=config,
                                 dataset=JaxDataset.create(config))
        assert job.epoch == 2
        assert np.isfinite(job.run()["avg_loss"]) and job.epoch == 3


def _resume(package, checkpoint_file, dataset, sparse_updates):
    """kge_tpu's (``package`` "jax") or the port's job resumed from a
    checkpoint for one more epoch, without a folder, under the given
    ``tpu.sparse_updates``; returns (job, its epochs' losses)."""
    jax_side = package == "jax"
    checkpoint = (jax_load_checkpoint if jax_side
                  else load_checkpoint)(checkpoint_file)
    checkpoint.pop("folder")
    config = (JaxConfig if jax_side else Config).create_from(checkpoint)
    config.set("tpu.sparse_updates", sparse_updates)
    config.set("train.max_epochs", 2)
    job = (JaxJob if jax_side else Job).create_from(
        checkpoint, new_config=config, dataset=dataset)
    assert job.epoch == 1
    losses = record_epochs(job)
    job.run()
    return job, losses


@pytest.mark.parametrize("writer", ["kge_tpu", "port"])
def test_sparse_checkpoints_cross_over(writer, tmp_path):
    """A row-sparse run's checkpoint after epoch 1, in kge_tpu's sparse
    layout (the Adagrad sums under ``opt_state["sparse"]``), resumes in
    the other package, row-sparse and dense, on the writer's own
    trajectory: epoch losses rtol 1e-5, tables atol 1e-4 (Adagrad's sign
    trap, tests/test_torch_train.py)."""
    options = {"tpu.sparse_updates": "always",
               "tpu.fused_negsamp_loss": "always", "train.max_epochs": 1}
    make = jax_job if writer == "kge_tpu" else port_job
    run = make(options, str(tmp_path / writer))
    run.run()
    checkpoint_file = run.config.checkpoint_file(1)
    opt_state = jax_load_checkpoint(checkpoint_file)["opt_state"]
    assert set(opt_state) == {"sparse", "tx"}
    assert set(opt_state["sparse"]) == {"entity_embedder.weights",
                                        "relation_embedder.weights"}
    datasets = {"jax": JaxDataset.create(make_config(JaxConfig, options),
                                         TOY),
                "port": Dataset.create(make_config(Config, options), TOY)}
    own = "jax" if writer == "kge_tpu" else "port"
    other = "port" if own == "jax" else "jax"
    want_job, want = _resume(own, checkpoint_file, datasets[own], "always")
    tables = jax_tables if own == "jax" else port_tables
    other_tables = port_tables if own == "jax" else jax_tables
    for mode in ("always", "never"):
        job, got = _resume(other, checkpoint_file, datasets[other], mode)
        assert len(job._sparse_paths) == (2 if mode == "always" else 0)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert_tables_close(other_tables(job), tables(want_job),
                            **TABLE_TOL)


VERBS_SCRIPT = """
import json, sys
from kge_tpu_torch import cli

folder, libkge_file, out = sys.argv[1:4]
cpu = ["--job.device", "cpu", "--console.quiet", "true"]
run = out + "/bf16"
started = cli.main(["start", "examples/toy-complex-train.yaml", "--folder",
                    run, "--train.max_epochs", "1", "--valid.every", "1",
                    "--train.type", "negative_sampling",
                    "--negative_sampling.shared", "true",
                    "--negative_sampling.implementation", "batch",
                    "--train.loss", "kl", "--tpu.compute_dtype", "bfloat16",
                    *cpu])
loss = cli.main(["valid", run, "--eval.type", "training_loss", *cpu])
cli.main(["package", run + "/checkpoint_best.pt", "--file",
          out + "/model.pt"])
cli.main(["import-libkge", libkge_file, "--file", out + "/imported.pt"])
cli.main(["dump", "trace", run])
cli.main(["dump", "checkpoint", out + "/model.pt"])
cli.main(["dump", "checkpoint", out + "/imported.pt"])
search = cli.main(["start", "examples/toy-complex-search-grid.yaml",
                   "--folder", out + "/grid", "--train.max_epochs", "1",
                   "--valid.every", "1", *cpu])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print(json.dumps(dict(loaded=loaded, epoch=started["epoch"],
                      loss_type=loss["type"], avg_loss=loss["avg_loss"],
                      best_trial=search["best_trial"])))
"""


def test_cli_verbs_without_importing_kge_tpu(jax_folder, tmp_path):
    """package, import-libkge, dump trace and dump checkpoint, a bf16
    start, a training_loss validation and the toy grid search example, in
    a subprocess that loads no JAX module; kge_tpu loads the package and
    the imported checkpoint."""
    libkge_file = str(tmp_path / "libkge.pt")
    rng = np.random.default_rng(0)
    torch.save({"type": "train", "epoch": 3, "valid_trace": [],
                "model": ({
                    "_entity_embedder._embeddings.weight": torch.from_numpy(
                        rng.normal(size=(120, 16)).astype(np.float32)),
                    "_relation_embedder._embeddings.weight":
                        torch.from_numpy(rng.normal(size=(9, 16))
                                         .astype(np.float32))}, {}),
                "config": {"model": "complex", "lookup_embedder": {"dim": 16},
                           "job": {"device": "cuda"}}}, libkge_file)
    out = str(tmp_path / "out")
    os.makedirs(out)
    r = _run(["-c", VERBS_SCRIPT, jax_folder, libkge_file, out],
             env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["epoch"] == 1 and result["loss_type"] == "training_loss"
    assert np.isfinite(result["avg_loss"])
    assert result["best_trial"] in (0, 1, 2, 3)
    assert "parameter_names:" in r.stdout and "avg_loss" in r.stdout
    model, params, _ = JaxKgeModel.create_from(
        jax_load_checkpoint(os.path.join(out, "model.pt")))
    assert model.dataset.num_entities() == 120
    imported = jax_load_checkpoint(os.path.join(out, "imported.pt"))
    assert imported["type"] == "import" and imported["epoch"] == 3
    JaxKgeModel.create_from(imported)


MESH_SCRIPT = """
import json, sys
from kge_tpu_torch import cli

folder = sys.argv[1]
cpu = ["--job.device", "cpu", "--console.quiet", "true"]
started = cli.main(["start", "examples/toy-complex-train.yaml",
                    "--folder", folder, "--train.max_epochs", "1",
                    "--valid.every", "1", "--tpu.mesh.data", "2",
                    "--tpu.mesh.model", "2", *cpu])
resumed = cli.main(["resume", folder, "--train.max_epochs", "2", *cpu])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print("RESULT " + json.dumps(dict(
    loaded=loaded, epochs=[started["epoch"], resumed["epoch"]],
    loss=resumed["avg_loss"])))
"""


RGNN_MESH_SCRIPT = """
import json, sys
from kge_tpu_torch import cli, native
from kge_tpu_torch.parallel.collectives import halo_exchange

folder, dataset = sys.argv[1:3]
result = cli.main(["start", "examples/toy-transe-compgcn-train.yaml",
                   "--folder", folder, "--dataset.name", dataset,
                   "--train.max_epochs", "1", "--valid.every", "1",
                   "--tpu.mesh.model", "2", "--job.device", "cpu",
                   "--console.quiet", "true"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print("RESULT " + json.dumps(dict(
    loaded=loaded, loss=result["avg_loss"], exchanges=halo_exchange.calls,
    host_ops=native.library() is not None)))
"""


def test_cli_rgnn_mesh_run_without_importing_kge_tpu(tmp_path):
    """CompGCN (``sub``, the halo route) by the CLI on two gloo ranks of
    a 1x2 mesh, its dataset (a fresh copy of data/toy, no caches) parsed
    by the g++ host ops: no rank loads a JAX module, the exchange ran,
    the ranks agree."""
    dataset = tmp_path / "toy"
    dataset.mkdir()
    for name in os.listdir(TOY):
        if not name.endswith(".pkl"):
            shutil.copy(os.path.join(TOY, name), dataset / name)
    outs = launch_ok(2, ["-c", RGNN_MESH_SCRIPT, str(tmp_path / "run"),
                         str(dataset)])
    results = [json.loads(line[len("RESULT "):]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(results) == 2
    for result in results:
        assert result["loaded"] == []
        assert result["exchanges"] > 0 and result["host_ops"]
        assert result["loss"] == results[0]["loss"]
    assert np.isfinite(results[0]["loss"])
    assert "triples-train.torch.cache.pkl" in os.listdir(dataset)


def test_cli_mesh_run_without_importing_kge_tpu(tmp_path):
    """``start`` and ``resume`` of the toy example on a 2x2 mesh, four
    gloo ranks of the CLI: no rank loads a JAX module, every rank reports
    the same epochs, rank 0 alone writes the checkpoints, and kge_tpu
    evaluates the best one."""
    folder = str(tmp_path / "mesh-run")
    outs = launch_ok(4, ["-c", MESH_SCRIPT, folder])
    results = [json.loads(line[len("RESULT "):]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(results) == 4
    for result in results:
        assert result["loaded"] == []
        assert result["epochs"] == [1, 2]
        assert result["loss"] == results[0]["loss"]
    names = os.listdir(folder)
    assert {"checkpoint_00002.pt", "checkpoint_best.pt", "proc1", "proc2",
            "proc3"} <= set(names)
    for rank in (1, 2, 3):
        assert not [n for n in os.listdir(os.path.join(folder, f"proc{rank}"))
                    if n.startswith("checkpoint")]
    assert [e["epoch"] for e in epoch_entries(folder)] == [1, 2]
    want = jax_eval(os.path.join(folder, "checkpoint_best.pt"), folder)
    assert np.isfinite(want["mean_reciprocal_rank_filtered"])
