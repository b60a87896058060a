"""The port's CLI end to end on a checkpoint that kge_tpu trains: ``python
-m kge_tpu_torch test`` gives kge_tpu's metrics, loads the checkpoint
without importing kge_tpu, optax or jax, and a checkpoint the port writes
loads and evaluates in kge_tpu.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, cli
from kge_tpu_torch.utils.misc import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_device_auto_without_cuda_raises(jax_folder):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = Config()
    assert config.get("job.device") == "auto"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["test", jax_folder, "--job.device", "auto"])
    config.set("job.device", "cuda:1")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(config)


def test_dump_config_and_unported_verbs(jax_folder, capsys):
    cli.main(["dump", "config", jax_folder, "--minimal"])
    out = capsys.readouterr().out
    assert "lookup_embedder.dim: 16" in out
    assert "kge_tpu." not in out
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["start", "examples/toy-complex-train.yaml"])
