"""The port's entity-ranking evaluation on both routes against kge_tpu's,
on one carried param tree over data/toy: every metric equal to 1e-9.

- generic (``score_sp_po`` over entity chunks, -inf masking): TransE and
  RotatE with L1, TransH, and DistMult forced generic, with chunk sizes
  that leave a ragged last chunk;
- fused with a monotone dot form (the true scores from the dot path):
  TransE and RotatE with L2, through the rank-count kernel's plain
  version;
- fused sp_-only dot forms under the reciprocal wrapper: ConvE and the
  Transformer, with the model state read in eval mode.

The spo consistency check opts out for a model that cannot score spo
both ways, as kge_tpu's does; bare ConvE and the Transformer fail their
true-score pass with kge_tpu's error (neither scores _po).
"""

import jax
import numpy as np
import pytest
import torch

from kge_tpu import Dataset as JaxDataset, Config as JaxConfig
from kge_tpu.evaluation.eval import EvaluationJob as JaxEvaluationJob
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.models import KgeModel
from tests.test_torch_model_zoo import model_config
from tests.test_torch_train import TOY

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

EVAL = {"job.type": "eval", "eval.split": "test"}
CONVE = {"lookup_embedder.dim": 8}
TRANSFORMER = {"transformer.encoder.nhead": 2,
               "transformer.encoder.dim_feedforward": 24,
               "transformer.encoder.num_layers": 2}

#: name -> (model, reciprocal?, options, route)
CASES = {
    "transe-l1": ("transe", False, {}, "generic"),
    "rotate-l1": ("rotate", False, {"entity_ranking.chunk_size": 50},
                  "generic"),
    "transh": ("transh", False, {"entity_ranking.chunk_size": 37,
                                 "eval.batch_size": 16}, "generic"),
    "distmult-generic": ("distmult", False,
                         {"entity_ranking.implementation": "generic",
                          "entity_ranking.chunk_size": 64,
                          "entity_ranking.tie_handling.type": "worst_rank",
                          "entity_ranking.metrics_per.head_and_tail": True},
                         "generic"),
    "transe-l1-filtered-with-test": (
        "transe", False, {"eval.split": "valid",
                          "entity_ranking.filter_splits": ["train", "valid"],
                          "entity_ranking.chunk_size": 50}, "generic"),
    "transe-l2": ("transe", False, {"transe.l_norm": 2.0}, "fused"),
    "rotate-l2": ("rotate", False,
                  {"rotate.l_norm": 2.0, "eval.split": "valid",
                   "entity_ranking.filter_splits": ["train", "valid"],
                   "entity_ranking.metrics_per.relation_type": True},
                  "fused"),
    "reciprocal-conve": ("conve", True, CONVE, "fused"),
    "reciprocal-transformer": ("transformer", True, TRANSFORMER, "fused"),
}


def jobs(model, reciprocal, options, seed=3, state_fn=None):
    """(kge_tpu eval job, port eval job) over the same weights and
    model state."""
    options = {**EVAL, **options}
    jconfig = model_config(JaxConfig, model, reciprocal, options)
    jdataset = JaxDataset.create(jconfig, TOY)
    jax_model = JaxKgeModel.create(jconfig, jdataset)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed)))
    state = jax_model.init_state()
    if state_fn is not None:
        state = state_fn(state)
    jax_job = JaxEvaluationJob.create(jconfig, jdataset, model=jax_model)
    jax_job.set_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                       state)
    pconfig = model_config(Config, model, reciprocal, options)
    pdataset = Dataset.create(pconfig, TOY)
    port = KgeModel.create(pconfig, pdataset, device=torch.device("cpu"),
                           init_for_load_only=True)
    port.load_params(tree)
    port.load_state(jax.tree_util.tree_map(np.asarray, state))
    job = EvaluationJob.create(pconfig, pdataset, model=port)
    for j in (jax_job, job):
        j.verbose = False
    return jax_job, job


def _metrics(trace):
    return {k: v for k, v in trace.items() if k.startswith(("mean_", "hits_"))}


def assert_metrics_equal(got, want):
    got, want = _metrics(got), _metrics(want)
    assert set(got) == set(want) and want
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, atol=1e-9,
                                   err_msg=key)


def _running_stats(state):
    """ConvE's batch-norm statistics away from their initial values."""
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: jax.numpy.asarray(
            np.abs(rng.normal(size=x.shape)).astype(np.float32) + 0.5), state)


@pytest.mark.parametrize("name", list(CASES))
def test_every_metric_equals_kge_tpu(name):
    model, reciprocal, options, route = CASES[name]
    state_fn = _running_stats if model == "conve" else None
    jax_job, job = jobs(model, reciprocal, options, state_fn=state_fn)
    assert job._use_fused() == (route == "fused") == jax_job._use_fused()
    want = jax_job._run()
    got = job._run()
    assert_metrics_equal(got, want)
    assert job._spo_supported is True
    if "filter_splits" in str(options):
        assert "mean_reciprocal_rank_filtered_with_test" in got


def test_generic_counts_equal_fused_counts():
    """DistMult ranked by both routes in the port: the same metrics
    (the chunked scores and the kernel's plain version agree)."""
    _, fused = jobs("distmult", False, {})
    _, generic = jobs("distmult", False, {
        "entity_ranking.implementation": "generic",
        "entity_ranking.chunk_size": 17})
    assert fused._use_fused() and not generic._use_fused()
    assert_metrics_equal(generic._run(), fused._run())


def _no_spo_from_the_subject_side(model):
    """Make ``model`` unable to score spo for direction "s" (as a model
    with an object-only spo form); both evaluations pass the direction
    by keyword."""
    score_spo = model.score_spo

    def refusing(*args, direction=None, **kwargs):
        if direction == "s":
            raise ValueError("this model scores spo for objects only")
        return score_spo(*args, direction=direction, **kwargs)

    model.score_spo = refusing


@pytest.mark.parametrize("implementation", ["fused", "generic"])
def test_spo_check_opts_out_as_kge_tpu(implementation):
    """A model that cannot score spo both ways: kge_tpu skips the spo
    consistency check (its ``_spo_consistency_scores`` catches the
    ValueError), and so does the port, with the same metrics."""
    jax_job, job = jobs("distmult", False, {
        "entity_ranking.implementation": implementation})
    _no_spo_from_the_subject_side(jax_job.model)
    _no_spo_from_the_subject_side(job.model)
    with pytest.raises(ValueError, match="objects only"):
        job.model.score_spo(torch.tensor([0]), torch.tensor([0]),
                            torch.tensor([1]), direction="s")
    want = jax_job._run()
    got = job._run()
    assert jax_job._spo_fn is False and job._spo_supported is False
    assert_metrics_equal(got, want)


@pytest.mark.parametrize("model,options", [("conve", CONVE),
                                           ("transformer", TRANSFORMER)])
@pytest.mark.parametrize("implementation", ["auto", "generic"])
def test_bare_sp_only_models_fail_as_kge_tpu(model, options, implementation):
    """Bare ConvE and Transformer score sp_ and spo only: both packages
    stop in the true-score pass with the same ValueError (``score_po``
    has no form for them), before any spo check."""
    jax_job, job = jobs(model, False, {
        **options, "entity_ranking.implementation": implementation})
    errors = []
    for j in (jax_job, job):
        with pytest.raises(ValueError) as info:
            j._run()
        errors.append(str(info.value))
    assert errors[0] == errors[1] == (
        f"combine _po not supported by "
        f"{'ConvE' if model == 'conve' else 'Transformer'}")
