"""The port's hyperparameter search (kge_tpu_torch/search) against
kge_tpu's on the tiny fixture dataset:

- grid and manual expansions give kge_tpu's trial folders and trial
  configurations (``run: False``, nothing trained);
- the native backend of ``ax_search`` (no ax-platform): its scrambled
  Sobol arms, its GP-EI proposals given the same stored results, the
  constrained Sobol and fallback streams and the constraint parser equal
  kge_tpu's exactly. These call the generators directly, with no
  training (tests/test_search.py, which trains, is marked slow);
- a whole grid search, a sharded manual search (delegated results read
  from the other shard's trace files) and an ``ax_search`` with
  ``resume`` (which reruns no trial) run in the port.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.search.ax import AxSearchJob as JaxAxSearchJob
from kge_tpu.train.job import Job as JaxJob
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.search.ax import AxSearchJob
from kge_tpu_torch.train.job import Job

from tests.util import get_dataset_folder

torch.set_num_threads(1)

METRIC = "mean_reciprocal_rank_filtered"


def search_config(cls, folder, search_type, **options):
    config = cls()
    config.set("model", "complex")
    config._import("complex")
    for key, value in {
        "job.device": "cpu", "job.type": "search",
        "search.type": search_type, "search.num_workers": 1,
        "dataset.name": "dataset_test", "train.type": "1vsAll",
        "train.max_epochs": 1, "train.batch_size": 4, "valid.every": 1,
        "valid.metric": METRIC, "lookup_embedder.dim": 8,
        "random_seed.default": 3, "console.quiet": True, **options,
    }.items():
        config.set(key, value)
    config.folder = str(folder)
    config.init_folder()
    return config


def make_job(cls, folder, search_type, **options):
    config = search_config(cls, folder, search_type, **options)
    dataset_cls = JaxDataset if cls is JaxConfig else Dataset
    job_cls = JaxJob if cls is JaxConfig else Job
    dataset = dataset_cls.create(config, get_dataset_folder("dataset_test"))
    return job_cls.create(config, dataset)


def trial_configs(folder):
    """{trial folder: its flattened config.yaml} of a search folder."""
    out = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name, "config.yaml")
        if os.path.isfile(path):
            with open(path) as f:
                out[name] = JaxConfig.flatten(yaml.safe_load(f))
    return out


EXPANSIONS = {
    "grid_search": {
        "grid_search.run": False,
        "grid_search.parameters": {
            "train.optimizer.default.args.lr": [0.1, 0.3],
            "lookup_embedder": {"dim": [8, 16]},
            "train.loss": ["kl", "bce"]}},
    "manual_search": {
        "manual_search.run": False,
        "manual_search.configurations": [
            {"folder": "lr01", "train.optimizer.default.args.lr": 0.1},
            {"train": {"optimizer": {"default": {"args": {"lr": 0.5}}}},
             "lookup_embedder.dim": 4},
        ]},
}


@pytest.mark.parametrize("search_type", list(EXPANSIONS))
def test_expansion_matches_kge_tpu(search_type, tmp_path):
    options = EXPANSIONS[search_type]
    for cls, name in ((JaxConfig, "jax"), (Config, "port")):
        make_job(cls, tmp_path / name, search_type, **options).run()
    want = trial_configs(tmp_path / "jax")
    got = trial_configs(tmp_path / "port")
    assert list(got) == list(want) and len(got) in (2, 8)
    for trial in want:
        assert got[trial] == want[trial], trial
        assert got[trial]["job.type"] == "train"


SPACE = [
    {"name": "train.optimizer.default.args.lr", "type": "range",
     "bounds": [0.01, 1.0], "log_scale": True},
    {"name": "lookup_embedder.dim", "type": "choice", "values": [8, 16, 32]},
    {"name": "train.batch_size", "type": "range", "bounds": [2, 64]},
    {"name": "train.loss", "type": "fixed", "value": "kl"},
]
CONSTRAINED = [
    {"name": "a", "type": "range", "bounds": [0.0, 1.0]},
    {"name": "b", "type": "range", "bounds": [0.0, 1.0]},
]


def backends(tmp_path, space, **options):
    """(kge_tpu's, the port's) AxSearchJob on the native backend."""
    jobs = []
    for cls, job_cls, dataset_cls in ((JaxConfig, JaxAxSearchJob,
                                       JaxDataset),
                                      (Config, AxSearchJob, Dataset)):
        config = search_config(cls, tmp_path / cls.__module__,
                               "ax_search", **{"ax_search.parameters": space,
                                               **options})
        job = job_cls(config, dataset_cls.create(
            config, get_dataset_folder("dataset_test")))
        job.init_search()
        jobs.append(job)
    return jobs


def objective(params):
    values = [float(v) for v in params.values() if not isinstance(v, str)]
    return {METRIC: float(-np.sum((np.log(np.abs(values) + 1e-3)
                                   - np.log(0.1)) ** 2))}


def propose(job, n):
    """n arms from register_trial, each given its objective as result."""
    arms = []
    for _ in range(n):
        params, trial_id = job.register_trial()
        arms.append((params, trial_id))
        job.parameters.append(params)
        job.results.append(objective(params))
    return arms


def test_sobol_and_gp_ei_arms_match_kge_tpu(tmp_path):
    jax_job, port_job = backends(tmp_path, SPACE,
                                 **{"ax_search.num_trials": 9,
                                    "ax_search.num_sobol_trials": 5})
    # 5 Sobol arms, then the GP-EI phase on the same stored results
    assert propose(port_job, 9) == propose(jax_job, 9)
    assert port_job.register_trial() == jax_job.register_trial() == (
        None, None)
    # the GP-EI point of other stored results
    values = np.random.default_rng(0).normal(size=9)
    for job in (jax_job, port_job):
        job.results = [{METRIC: float(v)} for v in values]
    assert port_job._gp_ei_point() == jax_job._gp_ei_point()


def test_constrained_streams_match_kge_tpu(tmp_path):
    options = {"ax_search.num_trials": 12, "ax_search.num_sobol_trials": 6,
               "ax_search.parameter_constraints": ["a + b <= 1.0",
                                                   "a >= b"]}
    jax_job, port_job = backends(tmp_path, CONSTRAINED, **options)
    arms = propose(port_job, 12)
    assert arms == propose(jax_job, 12)
    for params, _ in arms:
        assert params["a"] + params["b"] <= 1.0 + 1e-9
        assert params["a"] >= params["b"] - 1e-9
    for trial_id in (0, 3, 7):
        np.testing.assert_array_equal(port_job._fallback_point(trial_id),
                                      jax_job._fallback_point(trial_id))
    # the unconstrained fallback stream, positioned by trial id
    jax_free, port_free = backends(tmp_path / "free", CONSTRAINED)
    for trial_id in (0, 5):
        np.testing.assert_array_equal(port_free._fallback_point(trial_id),
                                      jax_free._fallback_point(trial_id))


def test_constraint_parser_matches_kge_tpu():
    constraints = ["2*a + b <= 5", "a - b >= 0", "a <= b",
                   "a + 1 <= 2*b - 0.5", "a <= 1e-3", "2e-2*a + b >= 0",
                   "a - 1E+2*b <= 2.5e-1"]
    parsed = AxSearchJob._parse_constraints(constraints)
    assert parsed == JaxAxSearchJob._parse_constraints(constraints)
    assert parsed[3] == ({"a": 1.0, "b": -2.0}, "<=", -1.5)
    with pytest.raises(ValueError, match="unsupported constraint"):
        AxSearchJob._parse_constraints(["a == b"])


def test_grid_search_runs(tmp_path):
    job = make_job(Config, tmp_path / "grid", "grid_search", **{
        "grid_search.parameters": {
            "train.optimizer.default.args.lr": [0.1, 0.3],
            "lookup_embedder.dim": [8]}})
    result = job.run()
    assert result["best_trial"] in (0, 1)
    folders = sorted(os.listdir(tmp_path / "grid"))
    trials = [f for f in folders if f.startswith("tra-")]
    assert len(trials) == 2
    for trial in trials:
        assert os.path.isfile(tmp_path / "grid" / trial /
                              "checkpoint_best.pt")
    with open(tmp_path / "grid" / "trace.yaml") as f:
        entries = [yaml.safe_load(line) for line in f]
    copied = [e for e in entries if e.get("scope") == "train"
              and METRIC in e]
    assert sorted(e["train_job_index"] for e in copied) == [0, 1]
    assert any(e.get("event") == "search_completed" for e in entries)


def test_sharded_manual_search_reads_delegated_results(tmp_path):
    configurations = [{"folder": f"t{i}",
                       "train.optimizer.default.args.lr": lr}
                      for i, lr in enumerate([0.05, 0.2])]

    def shard(index, folder):
        return make_job(Config, folder, "manual_search", **{
            "search.num_shards": 2, "search.shard_index": index,
            "manual_search.configurations": configurations})

    shard(1, tmp_path / "search").run()
    # shard 0 over the same folder: runs t0, reads t1 from its trace
    second = tmp_path / "shard0"
    job = shard(0, second)
    shutil.rmtree(second)
    job.config.folder = str(tmp_path / "search")
    job.config.init_folder()
    result = job.run()
    assert result["best_trial"] in (0, 1)
    assert os.path.isfile(tmp_path / "search" / "t0" / "checkpoint_best.pt")


def test_ax_search_resume_reruns_no_trial(tmp_path):
    options = {"ax_search.num_trials": 3, "ax_search.num_sobol_trials": 2,
               "ax_search.parameters": SPACE[:2]}
    job = make_job(Config, tmp_path / "ax", "ax_search", **options)
    result = job.run()
    assert result["best_trial"] is not None and len(job.parameters) == 3
    checkpoint = os.path.join(tmp_path, "ax", "checkpoint_00000.pt")
    with open(checkpoint, "rb") as f:
        stored = __import__("pickle").load(f)
    assert stored["type"] == "search" and isinstance(stored["config"], dict)

    def starts():
        return sum(open(os.path.join(tmp_path, "ax", t, "kge.log")).read()
                   .count("Starting training job") for t in
                   ("00000", "00001", "00002"))

    assert starts() == 3
    resumed = make_job(Config, tmp_path / "ax2", "ax_search", **options)
    resumed.config.folder = str(tmp_path / "ax")
    again = resumed.run()
    assert resumed.parameters == job.parameters
    assert again["best_trial"] == result["best_trial"]
    assert starts() == 3
