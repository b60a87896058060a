"""The port's other evaluation types against kge_tpu's on one shared
ComplEx param tree (the helpers of tests/test_torch_eval.py):

- ``training_loss``: a forward-only epoch of the configured trainer over
  the evaluation split, ``avg_loss`` within 1e-5 relative of kge_tpu's,
  under negative sampling (shared, through K1's plain version, and
  per-row), KvsAll and 1vsAll; the model it shares keeps its gradient
  flags;
- ``entity_pair_ranking``: every metric equal to kge_tpu's to 1e-9 at two
  chunk sizes (all subjects at once, and chunks of 3 that pad the last
  one), raw and filtered, and to the brute-force count of
  tests/test_entity_pair_ranking.py.
"""

import numpy as np
import pytest
import torch

from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.models import Ctx
from kge_tpu_torch.train.train import TrainingJob

from tests.test_torch_eval import _metrics, jobs

torch.set_num_threads(1)

TRAINING_LOSS = {
    "negative-sampling-shared-kl": {
        "train.type": "negative_sampling", "train.loss": "kl",
        "negative_sampling.shared": True,
        "negative_sampling.implementation": "batch",
        "tpu.fused_negsamp_loss": "always"},
    "negative-sampling-bce": {"train.type": "negative_sampling",
                              "train.loss": "bce"},
    "kvsall-bce-smoothing": {"train.type": "KvsAll", "train.loss": "bce",
                             "KvsAll.label_smoothing": 0.1},
    "1vsall-kl": {"train.type": "1vsAll", "train.loss": "kl"},
}


@pytest.mark.parametrize("name", list(TRAINING_LOSS))
def test_training_loss_matches_kge_tpu(name):
    options = {"eval.type": "training_loss", "eval.split": "valid",
               "train.batch_size": 16, "random_seed.default": 5,
               "negative_sampling.num_samples.s": 5,
               "negative_sampling.num_samples.o": 5,
               "tpu.on_device_sampling": "never", **TRAINING_LOSS[name]}
    jax_job, job, model = jobs("toy", options)
    assert type(job).__name__ == "TrainingLossEvaluationJob"
    want, got = jax_job.run(), job.run()
    assert got["type"] == "training_loss" and got["split"] == "valid"
    assert got["size"] == want["size"]  # triples, or KvsAll's queries
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["avg_cost"], want["avg_cost"], rtol=1e-5)


def test_training_loss_leaves_a_shared_model_trainable():
    """A forward-only job on a training job's model (the validation of a
    run with ``eval.type: training_loss``) leaves its gradient flags."""
    _, job, model = jobs("toy", {"eval.type": "training_loss",
                                 "eval.split": "valid",
                                 "train.type": "1vsAll"})
    train_conf = job.config.clone()
    train_conf.set("job.type", "train")
    trainer = TrainingJob.create(train_conf, job.dataset, model=model)
    assert all(p.requires_grad for p in model.parameters())
    EvaluationJob.create(job.config, job.dataset, model=trainer.model).run()
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("chunk_size", [-1, 3])
@pytest.mark.parametrize("dataset_name", ["dataset_test", "toy"])
def test_entity_pair_ranking_matches_kge_tpu(dataset_name, chunk_size):
    options = {"eval.type": "entity_pair_ranking",
               "entity_pair_ranking.chunk_size": chunk_size,
               "entity_ranking.hits_at_k_s": [1, 3, 10],
               "eval.batch_size": 4}
    if dataset_name == "toy":
        options["eval.split"] = "valid"
    jax_job, job, model = jobs(dataset_name, options)
    assert type(job).__name__ == "EntityPairRankingJob"
    want, got = _metrics(jax_job.run()), _metrics(job.run())
    assert set(got) == set(want) and "mean_reciprocal_rank_filtered" in got
    for key in want:  # the metric expression's NaNs compare equal
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9,
                                   err_msg=key)
    if dataset_name == "dataset_test":
        _assert_brute_force(job, model, got)


def _assert_brute_force(job, model, got):
    """Score every (s', o') pair under each test triple's relation, rank
    the true pair with rounded-mean-rank ties, filter the relation's true
    pairs (tests/test_entity_pair_ranking.py's referee)."""
    dataset = job.dataset
    E = dataset.num_entities()
    atol, rtol = 1e-5, 1e-4
    pairs_by_p = {}
    for split in ("train", "valid", "test"):
        for s, p, o in np.asarray(dataset.split(split)):
            pairs_by_p.setdefault(int(p), set()).add((int(s), int(o)))

    def final(g, t):
        return g + (max(t - 1, 0) + 1) // 2

    raw, filtered = [], []
    for s, p, o in np.asarray(dataset.split("test")):
        s, p, o = int(s), int(p), int(o)
        with torch.no_grad():
            m = model.score_spo(
                torch.arange(E).repeat_interleave(E), torch.full((E * E,), p),
                torch.arange(E).repeat(E), direction="o", ctx=Ctx(),
            ).reshape(E, E).numpy()
        t = m[s, o]
        close = np.abs(m - t) <= atol + rtol * np.abs(t)
        greater = (m > t) & ~close
        mask = np.zeros((E, E), bool)
        for fs, fo in pairs_by_p.get(p, set()) - {(s, o)}:
            mask[fs, fo] = True
        raw.append(final(int(greater.sum()), int(close.sum())) + 1)
        filtered.append(final(int((greater & ~mask).sum()),
                              int(close.sum()) - int((close & mask).sum()))
                        + 1)
    assert abs(got["mean_reciprocal_rank"]
               - np.mean(1.0 / np.asarray(raw))) < 1e-9
    assert abs(got["mean_reciprocal_rank_filtered"]
               - np.mean(1.0 / np.asarray(filtered))) < 1e-9
    assert abs(got["mean_rank_filtered"] - np.mean(filtered)) < 1e-9
