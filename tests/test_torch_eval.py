"""The port's entity-ranking evaluation (kge_tpu_torch/evaluation)
against kge_tpu's on one shared ComplEx param tree: every metric equal to
1e-9 (raw, filtered, filtered_with_test, head/tail, relation-type and
frequency drill-downs, all tie policies), the brute-force referee of
tests/test_eval.py, and NaN scores ranking last.
"""

import os

import numpy as np
import pytest
import torch

import jax

from kge_tpu import Dataset as JaxDataset
from kge_tpu.evaluation.eval import EvaluationJob as JaxEvaluationJob
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.models import KgeModel

from tests.util import create_config, get_dataset_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDERS = {"dataset_test": get_dataset_folder("dataset_test"),
           "toy": os.path.join(REPO, "data", "toy")}


def _apply(config, options):
    config.set("job.type", "eval")
    config.set("console.quiet", True)
    for key, value in options.items():
        config.set(key, value)


def jobs(dataset_name, options, seed=7, params_fn=None):
    """(kge_tpu job, port job, port model) evaluating the same weights."""
    options = {"eval.split": "test", "lookup_embedder.dim": 16, **options}
    config = create_config(dataset_name, model="complex")
    _apply(config, options)
    dataset = JaxDataset.create(config, FOLDERS[dataset_name])
    jax_model = JaxKgeModel.create(config, dataset)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed))
    )
    if params_fn is not None:
        tree = jax.tree_util.tree_map(params_fn, tree)
    jax_job = JaxEvaluationJob.create(config, dataset, model=jax_model)
    jax_job.set_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                       jax_model.init_state())

    pconfig = Config()
    pconfig.set("model", "complex")
    pconfig._import("complex")
    pconfig.set("job.device", "cpu")
    pconfig.set("dataset.name", dataset_name)
    _apply(pconfig, options)
    pdataset = Dataset.create(pconfig, FOLDERS[dataset_name])
    model = KgeModel.create(pconfig, pdataset, device=torch.device("cpu"),
                            init_for_load_only=True)
    model.load_params(tree)
    job = EvaluationJob.create(pconfig, pdataset, model=model)
    for j in (jax_job, job):
        j.verbose = False
    return jax_job, job, model


def _metrics(trace):
    return {k: v for k, v in trace.items() if k.startswith(("mean_", "hits_"))}


@pytest.mark.parametrize("dataset_name,options", [
    ("dataset_test", {}),
    ("dataset_test", {"eval.split": "valid",
                      "entity_ranking.filter_splits": ["train", "valid"]}),
    ("toy", {"eval.split": "valid", "eval.batch_size": 7,
             "entity_ranking.metrics_per.head_and_tail": True,
             "entity_ranking.metrics_per.relation_type": True,
             "entity_ranking.metrics_per.argument_frequency": True}),
    ("toy", {"entity_ranking.tie_handling.type": "best_rank",
             "eval.batch_size": 64}),
    ("toy", {"entity_ranking.tie_handling.type": "worst_rank",
             "entity_ranking.filter_with_test": False}),
])
def test_every_metric_equals_kge_tpu(dataset_name, options):
    jax_job, job, _ = jobs(dataset_name, options)
    want = _metrics(jax_job._run())
    got = _metrics(job._run())
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, atol=1e-9,
                                   err_msg=key)
    if options.get("entity_ranking.filter_splits") == ["train", "valid"]:
        assert "mean_reciprocal_rank_filtered_with_test" in got
    if options.get("entity_ranking.metrics_per.relation_type"):
        assert "mean_reciprocal_rank_filtered_head" in got
        assert "mean_reciprocal_rank_subject_top" in got


def _brute_force_metrics(model, dataset, hits_ks=(1, 2, 3)):
    """tests/test_eval.py's referee on the port's scores: filtering by
    -inf masking, tie counting with rtol/atol, rounded-mean ranks."""
    atol, rtol = 1e-5, 1e-4

    def final_rank(scores, true_score):
        close = np.abs(scores - true_score) <= atol + rtol * np.abs(true_score)
        greater = (scores > true_score) & ~close
        return greater.sum() + close.sum() // 2

    answers_sp, answers_po = {}, {}
    for split in ("train", "valid", "test"):
        for s, p, o in dataset.split(split):
            answers_sp.setdefault((s, p), set()).add(o)
            answers_po.setdefault((p, o), set()).add(s)
    ranks = {"raw": [], "filt": []}
    with torch.no_grad():
        for s, p, o in dataset.split("test"):
            t = lambda x: torch.tensor([int(x)])
            sp_scores = model.score_sp(t(s), t(p))[0].numpy()
            po_scores = model.score_po(t(p), t(o))[0].numpy()
            o_true, s_true = sp_scores[o], po_scores[s]
            ranks["raw"] += [final_rank(sp_scores, o_true),
                             final_rank(po_scores, s_true)]
            sp_scores[list(answers_sp[(s, p)])] = -np.inf
            po_scores[list(answers_po[(p, o)])] = -np.inf
            ranks["filt"] += [final_rank(sp_scores, o_true),
                              final_rank(po_scores, s_true)]
    out = {}
    for kind, rank_list in ranks.items():
        r = np.asarray(rank_list) + 1
        suffix = "" if kind == "raw" else "_filtered"
        out["mean_reciprocal_rank" + suffix] = float(np.mean(1.0 / r))
        out["mean_rank" + suffix] = float(np.mean(r))
        for k in hits_ks:
            out[f"hits_at_{k}{suffix}"] = float(np.mean(r <= k))
    return out


def test_entity_ranking_matches_brute_force():
    _, job, model = jobs("dataset_test", {
        "entity_ranking.filter_splits": ["train", "valid", "test"],
        "entity_ranking.hits_at_k_s": [1, 2, 3],
    })
    trace = job._run()
    for key, value in _brute_force_metrics(model, job.dataset).items():
        np.testing.assert_allclose(trace[key], value, rtol=1e-5, err_msg=key)


def test_nan_scores_rank_last_not_first():
    """cf. tests/test_eval.py::test_nan_scores_rank_last_not_first: NaN
    true scores become -inf and tie with every (-inf) candidate."""
    jax_job, job, _ = jobs("dataset_test", {},
                           params_fn=lambda x: np.full_like(x, np.nan))
    entry = job._run()
    E = job.dataset.num_entities()
    assert abs(entry["mean_reciprocal_rank"] - 1.0 / (E // 2 + 1)) < 1e-9
    assert _metrics(entry) == pytest.approx(_metrics(jax_job._run()),
                                            nan_ok=True)


def test_generic_implementation_not_yet_ported():
    """The generic route (once refused here) is ported: ComplEx ranked by
    chunked ``score_sp_po`` gives kge_tpu's generic metrics
    (tests/test_torch_eval_routes.py holds the other models)."""
    options = {"entity_ranking.implementation": "generic",
               "entity_ranking.chunk_size": 3}
    jax_job, job, _ = jobs("dataset_test", options)
    assert not job._use_fused()
    want = _metrics(jax_job._run())
    got = _metrics(job._run())
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, atol=1e-9,
                                   err_msg=key)
