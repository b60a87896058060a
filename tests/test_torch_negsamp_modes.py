"""The port's negative sampling beyond shared ``batch`` scoring against
kge_tpu's on data/toy (ComplEx dim 16, batch 32, two epochs, the same
seed, the JAX job's initial weights carried into the port): the
``triple`` and ``all`` scoring implementations with the kl, bce and
margin-ranking losses, dense and (``triple``) row-sparse; the default
sampler (not shared, 3 + 3 negatives, ``auto`` resolving to ``triple``);
the filtering of known positives and the frequency sampler, whose draws
equal kge_tpu's; and per-epoch graph sampling.

Tolerances as in tests/test_torch_train.py: the first step's loss rtol
1e-6, each epoch's avg_loss rtol 1e-5, the tables ``TABLE_TOL``.
"""

import jax
import numpy as np
import pytest
import torch

from kge_tpu import Dataset as JaxDataset
from kge_tpu.train import graph_util as jax_graph_util
from kge_tpu.train.sampler import KgeSampler as JaxKgeSampler
from kge_tpu_torch import Dataset
from kge_tpu_torch.ops import negsamp_loss as nl, row_update as ru
from kge_tpu_torch.train import graph_util
from kge_tpu_torch.train.sampler import KgeSampler
from tests.test_torch_sampler_optimizer import configs
from tests.test_torch_train import (
    TABLE_TOL, TOY, assert_tables_close, first_batch_loss, jax_job,
    jax_tables, port_job, port_tables, record_epochs,
)

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

#: kge_tpu's default sampler: not shared, 3 + 3 negatives, auto scoring
DEFAULT_SAMPLER = {
    "negative_sampling.shared": False,
    "negative_sampling.implementation": "auto",
    "negative_sampling.num_samples.s": 3,
    "negative_sampling.num_samples.o": -1,
}
#: row-sparse updates (tests/test_torch_sparse_train.py's setting)
SPARSE = {"tpu.sparse_updates": "always",
          "lookup_embedder.regularize_weight": 0.01,
          "lookup_embedder.regularize_args.weighted": True}
LOSSES = ("kl", "bce", "margin_ranking")

CASES = {
    **{f"triple-{loss}": {"train.loss": loss} for loss in LOSSES},
    **{f"all-{loss}": {"train.loss": loss,
                       "negative_sampling.implementation": "all"}
       for loss in LOSSES},
    **{f"triple-sparse-{loss}": {"train.loss": loss, **SPARSE}
       for loss in LOSSES},
    "triple-filtering": {"negative_sampling.num_samples.p": 2,
                         "negative_sampling.filtering.s": True,
                         "negative_sampling.filtering.p": True,
                         "negative_sampling.filtering.o": True},
    "triple-frequency": {"negative_sampling.sampling_type": "frequency"},
    "batch-not-shared-graph-uniform": {
        "negative_sampling.implementation": "batch",
        "negative_sampling.graph_sampling": "uniform",
        "negative_sampling.graph_sampling_size": 300},
    "triple-graph-edge_neighbourhood": {
        "negative_sampling.graph_sampling": "edge_neighbourhood",
        "negative_sampling.graph_sampling_size": 300},
}


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_kge_tpu(name, tmp_path):
    options = {**DEFAULT_SAMPLER, **CASES[name],
               "train.trace_level": "batch"}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(
        options, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    sparse = "sparse" in name
    assert len(jax_run._sparse_paths) == len(port_run._sparse_paths) == (
        2 if sparse else 0)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    launches = (nl.shared_ce_loss.launches, ru.adagrad_row_update.launches)
    jax_run.run()
    port_run.run()
    # the CPU run takes the plain versions: no kernel launch counted
    assert (nl.shared_ce_loss.launches,
            ru.adagrad_row_update.launches) == launches == (0, 0)
    implementation = name.split("-")[0]
    assert (port_run.config.get("negative_sampling.implementation")
            == jax_run.config.get("negative_sampling.implementation")
            == implementation)
    assert port_run.num_examples == jax_run.num_examples
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        **TABLE_TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_triple_sparse_matches_dense(loss):
    """The port's row-sparse and dense ``triple`` runs of one
    configuration, with an Adagrad accumulator that makes the update
    smooth in the gradient."""
    runs = {}
    for mode in ("always", "never"):
        job = port_job({**DEFAULT_SAMPLER, **SPARSE, "train.loss": loss,
                        "tpu.sparse_updates": mode,
                        "train.optimizer.default.args"
                        ".initial_accumulator_value": 0.1})
        losses = record_epochs(job)
        job.run()
        runs[mode] = (losses, port_tables(job))
    np.testing.assert_allclose(runs["always"][0], runs["never"][0],
                               rtol=1e-6)
    assert_tables_close(runs["always"][1], runs["never"][1],
                        rtol=1e-6, atol=1e-6)


def test_all_stays_dense():
    """``all`` scores every entity: kge_tpu's reason refuses row-sparse
    updates in both packages, with the same message."""
    options = {**DEFAULT_SAMPLER, **SPARSE,
               "negative_sampling.implementation": "all"}
    with pytest.raises(ValueError, match="scores every entity") as want:
        jax_job(options)
    with pytest.raises(ValueError, match="scores every entity") as got:
        port_job(options)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ sampler


def samplers(options, folder=TOY):
    jconfig, pconfig = configs({**DEFAULT_SAMPLER, **options})
    jdataset = JaxDataset.create(jconfig, folder)
    pdataset = Dataset.create(pconfig, folder)
    jsampler = JaxKgeSampler.create(jconfig, "negative_sampling", jdataset)
    psampler = KgeSampler.create(pconfig, "negative_sampling", pdataset)
    return jsampler, psampler, pdataset.split("train")


@pytest.mark.parametrize("options", [
    {"negative_sampling.num_samples.p": 4,
     "negative_sampling.filtering.s": True,
     "negative_sampling.filtering.p": True,
     "negative_sampling.filtering.o": True},
    {"negative_sampling.num_samples.s": 40,
     "negative_sampling.filtering.o": True,
     "negative_sampling.filtering.split": "valid"},
    {"negative_sampling.sampling_type": "frequency",
     "negative_sampling.num_samples.p": 4},
    {"negative_sampling.sampling_type": "frequency",
     "negative_sampling.frequency.smoothing": 0,
     "negative_sampling.filtering.o": True},
], ids=["filtering", "filtering-valid-split", "frequency",
        "frequency-filtering"])
def test_seeded_draws_identical(options):
    jsampler, psampler, train = samplers(options)
    np.testing.assert_array_equal(psampler.filter_positives,
                                  jsampler.filter_positives)
    for sampler in (jsampler, psampler):
        sampler.seed((5, 1))
    for start in range(0, 128, 32):
        triples = train[start:start + 32].astype(np.int32)
        for slot in (0, 1, 2):
            if psampler.num_samples[slot] <= 0:
                continue
            j, p = jsampler.sample(triples, slot), psampler.sample(triples,
                                                                  slot)
            np.testing.assert_array_equal(p.materialize(), j.materialize())
    # the generators stand at the same place afterwards
    assert psampler._rng.integers(2 ** 31) == jsampler._rng.integers(2 ** 31)


def test_filtering_removes_positives():
    _, psampler, train = samplers({"negative_sampling.num_samples.s": 40,
                                   "negative_sampling.filtering.s": True})
    psampler.seed(3)
    triples = train[:64].astype(np.int32)
    negatives = psampler.sample(triples, 0).materialize()
    index = psampler.dataset.index("train_po_to_s")
    for row, (s, p, o) in enumerate(triples):
        assert not set(negatives[row]) & set(index.get((p, o)).tolist())


def test_filtering_guard_gives_up_after_1000_rounds():
    """Where no candidate is a negative, both packages stop after 1000
    resample rounds, keep the positives and warn."""
    logs = {}
    out = {}
    for name, sampler in zip(("jax", "port"),
                             samplers({"negative_sampling.filtering.o":
                                       True})[:2]):
        logs[name] = []
        sampler.config.log = lambda msg, *a, log=logs[name], **k: log.append(
            msg)
        # every draw is the row's own positive object
        sampler._sample = lambda pos, slot, n: np.repeat(
            pos[:, slot:slot + 1], n, axis=1).astype(np.int32)
        triples = sampler.dataset.split("train")[:8].astype(np.int32)
        out[name] = sampler.sample(triples, 2).materialize()
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert logs["port"] == logs["jax"]
    assert "after 1000 rounds" in logs["port"][-1]


def test_shared_sampling_refusals_match_kge_tpu():
    """Filtering with shared sampling raises at construction, the
    frequency sampler with shared sampling when it samples; the same
    errors as kge_tpu's."""
    shared = {"negative_sampling.shared": True,
              "negative_sampling.implementation": "batch"}
    for options, stage in (
            ({"negative_sampling.filtering.o": True}, "create"),
            ({"negative_sampling.sampling_type": "frequency"}, "sample")):
        errors = []
        for make in (
                lambda: samplers({**shared, **options})[0],
                lambda: samplers({**shared, **options})[1]):
            with pytest.raises((ValueError, NotImplementedError)) as e:
                sampler = make()
                assert stage == "sample"
                sampler.sample(np.zeros((4, 3), dtype=np.int32), 0)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


# ------------------------------------------------------------------ graphs


@pytest.mark.parametrize("sampler", ["sample_uniform",
                                     "sample_edge_neighbourhood"])
def test_graph_samplers_draw_kge_tpus_subgraph(sampler):
    triples = Dataset.create(configs({})[1], TOY).split("train")
    for size in (1, 100, 300, 10_000):
        want = getattr(jax_graph_util, sampler)(
            triples, size, np.random.default_rng((7, size)))
        got = getattr(graph_util, sampler)(
            triples, size, np.random.default_rng((7, size)))
        np.testing.assert_array_equal(got, want)
        assert len(got) == min(size, len(triples))
