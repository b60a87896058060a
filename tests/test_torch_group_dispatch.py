"""Grouped dispatch (``tpu.steps_per_dispatch``) of the steps that a card
captures as CUDA graphs since dropout, the model state and row-sparse
updates are captured, on the CPU (where each group's steps run eagerly,
with the math of the captured ones): reciprocal ConvE by KvsAll (the
main path of chip_smoke.py, cut to data/toy) and row-sparse shared
negative sampling.

- ``_steps_per_dispatch()`` of a row-sparse job equals ``kge_tpu``'s on
  the same configuration (its ``_sparse_host_loop_only`` and row working
  set rules);
- ConvE with dropout on in groups of 4 equals the same batches one step
  at a time, and a resumed run the uninterrupted one, bit for bit
  (losses, parameters, batch-norm statistics);
- ConvE at dropout 0 in groups of 4 against ``kge_tpu``'s scanned groups:
  the first step's loss rtol 1e-6, each epoch's avg_loss rtol 1e-5, the
  batch-norm running statistics after the first step within 1e-6 (after
  more steps Adam's sign trap moves the biases they follow: PERF.md
  section 2);
- the model state's tensors keep their storage across steps and a load;
- a row-sparse epoch in groups of 4 equals groups of 1 bit for bit, and
  ``kge_tpu``'s epoch in groups of 4 within the trainers' tolerances;
- K3's plain version gives the same bits for a float learning rate and a
  0-d float32 tensor;
- ``_capture_unsupported_reasons`` lets dropout, model state,
  row-sparse steps and an R-GNN encoder on a fixed graph through and
  still names a device mesh and graph sampling;
- a replay (a stand-in graph on the CPU) adds its captured launches,
  ``ccorr_reduce``'s among them, counts its batches and is the span
  ``train.replay``; a rebuilt encoder graph (``set_graph``,
  ``prepare_job``'s halo rebuild) drops the captured groups;
- on a card (``cuda``): captured R-GNN jobs (CompGCN's spectral route
  with dropout and batch-norm state, RAGAT's attention, R-GCN's
  blocks) equal their per-batch eager jobs bit for bit, a resumed
  captured run the uninterrupted one, and ``ccorr_reduce`` counts 6
  launches a step through the replays; under a profiler, a capture
  after an eager step succeeds.
"""

import gc
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from torch.profiler import ProfilerActivity, profile

from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.ops import row_update as ru
from kge_tpu_torch.ops.ccorr_reduce import ccorr_reduce
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import COUNTED_KERNELS, TrainingJob, _Graph
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_model_zoo_train import (
    CASES as ZOO, NO_CONVE_DROPOUT, jobs as zoo_jobs,
    make_config as zoo_config,
)
from tests.test_torch_sparse_train import SPARSE, TABLES
from tests.test_torch_tracing import (
    COMPGCN_CONVE, NEGATIVE_SAMPLING, ROUTES, make_job as rgnn_make_job,
    options as rgnn_options,
)
from tests.test_torch_train import (
    TABLE_TOL, TOY, assert_tables_close, first_batch_loss, jax_job,
    jax_tables, port_job, port_tables, record_epochs,
)

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVE = "reciprocal-conve-kvsall-adam"
GROUP = {"tpu.steps_per_dispatch": 4}


# ----------------------------------------------------------------- group size

#: the toy entity table is 120 x 16 float32 (7,680 bytes), the relation
#: table 16 x 16 (1,024): a limit of 5,000 bytes chunks the entity table
#: in two buffers of 64 rows (4,096 bytes), one of 4,000 leaves those
#: buffers over it (kge_tpu's 8-row alignment)
BELOW = {"tpu.sparse_scatter_limit_bytes": 5000}
GROUP_SIZE_CASES = {
    "defaults": ({}, 4),
    "below-limit-chunks-auto": ({**BELOW,
                                 "tpu.sparse_table_chunks": "auto"}, 4),
    "below-limit-chunks-never": ({**BELOW,
                                  "tpu.sparse_table_chunks": "never"}, 1),
    "below-limit-chunks-2": ({**BELOW, "tpu.sparse_table_chunks": "2"}, 4),
    "chunks-over-limit-after-alignment": (
        {"tpu.sparse_scatter_limit_bytes": 4000}, 1),
    "row-kernel-keeps-tables-whole": (
        {**BELOW, "tpu.sparse_row_kernel": "always"}, 1),
    "split-phases": ({"tpu.sparse_split_phases": "always"}, 1),
    "pipelined-gather": ({"tpu.sparse_pipelined_gather": "always"}, 1),
    "group-rowset": ({"tpu.sparse_group_rowset": "always"}, 4),
    "group-rowset-chunked": ({**BELOW, "tpu.sparse_group_rowset": "always"},
                             16),
}


@pytest.mark.parametrize("name", list(GROUP_SIZE_CASES))
def test_sparse_steps_per_dispatch_matches_kge_tpu(name):
    options, want = GROUP_SIZE_CASES[name]
    options = {**SPARSE, **GROUP, **options}
    jax_run, port_run = jax_job(options), port_job(options)
    assert jax_run._sparse_paths == port_run._sparse_paths == TABLES
    assert port_run._steps_per_dispatch() == jax_run._steps_per_dispatch()
    assert port_run._steps_per_dispatch() == want


def test_dense_steps_per_dispatch_unchanged():
    """Off the row-sparse path the options change nothing."""
    job = port_job({**SPARSE, **GROUP, **BELOW,
                    "tpu.sparse_updates": "never",
                    "tpu.sparse_split_phases": "always"})
    assert job._sparse_paths == ()
    assert job._steps_per_dispatch() == 4


# ----------------------------------------------------------------- ConvE


def conve_job(tmp_path, label, dropout=True, **overrides):
    """A port job of reciprocal ConvE by KvsAll (dim 8, Adam), with its
    default dropout (0.2 on both embedders, 0.2 feature maps, 0.3
    projection) unless ``dropout`` is False."""
    model, reciprocal, options = ZOO[CONVE]
    if dropout:
        options = {k: v for k, v in options.items()
                   if k not in NO_CONVE_DROPOUT}
    config = zoo_config(Config, model, reciprocal, {**options, **overrides},
                        str(tmp_path / label))
    return TrainingJob.create(config, Dataset.create(config, TOY))


def in_group_order(job, k: int):
    """``job`` (one step a dispatch) takes its KvsAll batches in the order
    groups of ``k`` take them: ``kge_tpu`` regroups KvsAll's batches by
    the group size, so only that order compares step for step."""
    generate = job._generate_batches

    def regrouped(epoch):
        job._steps_per_dispatch = lambda: k  # read by the regrouping
        try:
            yield from generate(epoch)
        finally:
            del job._steps_per_dispatch

    job._generate_batches = regrouped


def batch_losses(job):
    """(epoch, batch, avg_loss) of every batch entry of the job's trace."""
    with open(os.path.join(job.config.folder, "trace.yaml")) as f:
        entries = [yaml.safe_load(line) for line in f]
    return [(e["epoch"], e["batch"], e["avg_loss"]) for e in entries
            if e.get("scope") == "batch"]


def state_arrays(job):
    return {f"{k}.{s}": v[s].cpu().numpy().copy()
            for k, v in job.model.model_state.items() for s in v}


def assert_same_run(a, b):
    """Parameters, optimizer state and model state equal bit for bit."""
    for (name, x), (_, y) in zip(a.model.named_parameters(),
                                 b.model.named_parameters()):
        np.testing.assert_array_equal(x.detach().cpu().numpy(),
                                      y.detach().cpu().numpy(), err_msg=name)
    for slot, tensors in a.opt_state.items():
        for key, value in tensors.items():
            np.testing.assert_array_equal(
                value.cpu().numpy(), b.opt_state[slot][key].cpu().numpy(),
                err_msg=f"{slot}/{key}")
    sa, sb = state_arrays(a), state_arrays(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


def test_conve_groups_equal_per_batch_steps(tmp_path):
    """Reciprocal ConvE with dropout: 2 epochs in groups of 4 and the same
    batches one step at a time give the same epoch losses, batch losses,
    parameters, Adam state and batch-norm statistics, bit for bit (one
    dropout stream an epoch, drawn in step order either way)."""
    runs, losses = {}, {}
    for label, k in (("grouped", 4), ("per-batch", 1)):
        job = conve_job(tmp_path, label, **{"tpu.steps_per_dispatch": k})
        if k == 1:
            in_group_order(job, 4)
        losses[label] = record_epochs(job)
        job.run()
        runs[label] = job
    assert runs["grouped"]._steps_per_dispatch() == 4
    assert len(losses["grouped"]) == 2
    assert losses["grouped"] == losses["per-batch"]
    grouped, per_batch = (batch_losses(runs[k]) for k in runs)
    assert grouped == per_batch and len(grouped) > 4
    assert_same_run(runs["grouped"], runs["per-batch"])
    # dropout drew masks: the losses are not those of dropout 0
    plain = conve_job(tmp_path, "no-dropout", dropout=False, **GROUP)
    plain_losses = record_epochs(plain)
    plain.run()
    assert not np.allclose(losses["grouped"], plain_losses, rtol=1e-3)


def test_conve_grouped_resume_equals_uninterrupted(tmp_path):
    """Groups of 4 with dropout: a run resumed after epoch 1 equals the
    uninterrupted run bit for bit (each epoch's dropout stream is seeded
    from the seed and the epoch)."""
    full = conve_job(tmp_path, "full", **GROUP)
    full_losses = record_epochs(full)
    full.run()
    cut = conve_job(tmp_path, "cut", **GROUP, **{"train.max_epochs": 1,
                                                 "train.checkpoint.every": 1})
    cut.run()
    resumed = Job.create_from(load_checkpoint(cut.config.checkpoint_file(1)),
                              dataset=cut.dataset)
    resumed.config.set("train.max_epochs", 2)
    resumed_losses = record_epochs(resumed)
    resumed.run()
    assert resumed_losses == full_losses[1:]
    assert_same_run(full, resumed)


def test_conve_groups_match_kge_tpu_at_dropout_0(tmp_path):
    """Groups of 4 in both packages (the same regrouped batch order):
    the first step's loss rtol 1e-6, each epoch's avg_loss rtol 1e-5; then
    one step from the same weights: the batch-norm running statistics
    within 1e-6."""
    jax_run, port_run = zoo_jobs(CONVE, tmp_path, **GROUP)
    assert jax_run._steps_per_dispatch() == port_run._steps_per_dispatch()
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)

    (tmp_path / "one-step").mkdir()
    jax_run, port_run = zoo_jobs(CONVE, tmp_path / "one-step", **GROUP,
                                 **{"train.max_epochs": 1})
    for job in (jax_run, port_run):
        generate = job._generate_batches
        job._generate_batches = (
            lambda epoch, generate=generate: iter([next(generate(epoch))]))
    jax_run.run()
    port_run.run()
    assert port_run.current_trace["epoch"]["batches"] == 1
    got, want = port_run.model.state(), jax_run.model_state
    for key in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(got[key][stat],
                                       np.asarray(want[key][stat]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{key}.{stat}")
    assert not np.allclose(got["bn2"]["var"], 1.0)


def test_model_state_keeps_its_storage(tmp_path):
    """The batch-norm statistics are updated in their tensors (where a
    captured graph reads them) by every step, and a checkpoint load
    copies into them."""
    job = conve_job(tmp_path, "storage", **GROUP,
                    **{"train.max_epochs": 1, "train.checkpoint.every": 1})
    tensors = {f"{k}.{s}": v[s] for k, v in job.model.model_state.items()
               for s in v}
    pointers = {k: t.data_ptr() for k, t in tensors.items()}
    before = {k: t.clone() for k, t in tensors.items()}
    job.run()
    after = {f"{k}.{s}": v[s] for k, v in job.model.model_state.items()
             for s in v}
    assert {k: t.data_ptr() for k, t in after.items()} == pointers
    assert all(after[k] is tensors[k] for k in tensors)
    assert not torch.equal(after["bn1.var"], before["bn1.var"])

    trained = state_arrays(job)
    fresh = conve_job(tmp_path, "storage-fresh", **GROUP)
    fresh_tensors = {f"{k}.{s}": v[s]
                     for k, v in fresh.model.model_state.items() for s in v}
    fresh_pointers = {k: t.data_ptr() for k, t in fresh_tensors.items()}
    fresh._load(load_checkpoint(job.config.checkpoint_file(1)))
    loaded = {f"{k}.{s}": v[s] for k, v in fresh.model.model_state.items()
              for s in v}
    assert {k: t.data_ptr() for k, t in loaded.items()} == fresh_pointers
    for key, value in trained.items():
        np.testing.assert_array_equal(loaded[key].numpy(), value)
    # an empty tree (kge_tpu's evaluation of a state-free checkpoint)
    # resets them in place
    fresh.model.load_state({})
    assert fresh.model.model_state["bn1"]["var"].data_ptr() == \
        fresh_pointers["bn1.var"]
    assert torch.equal(fresh.model.model_state["bn1"]["var"],
                       torch.ones_like(loaded["bn1.var"]))


# ----------------------------------------------------------------- row-sparse


def test_sparse_groups_equal_per_batch_steps():
    """A row-sparse run (K3's plain version, the fused loss) in groups of
    4 and one step a dispatch: epoch losses, tables and Adagrad sums bit
    for bit."""
    runs = {}
    for k in (4, 1):
        job = port_job({**SPARSE, "tpu.fused_negsamp_loss": "always",
                        "tpu.steps_per_dispatch": k})
        assert job._sparse_paths == TABLES
        assert job._steps_per_dispatch() == k
        losses = record_epochs(job)
        job.run()
        runs[k] = (losses, job)
    assert runs[4][0] == runs[1][0] and len(runs[4][0]) == 2
    assert_same_run(runs[4][1], runs[1][1])


def test_sparse_groups_match_kge_tpu(tmp_path):
    """Groups of 4 in both packages (kge_tpu scans them: its toy tables
    are under the scatter limit): the first step's loss rtol 1e-6, each
    epoch's avg_loss rtol 1e-5, the tables ``TABLE_TOL``."""
    options = {**SPARSE, **GROUP, "tpu.fused_negsamp_loss": "always"}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(options, str(tmp_path / "port"),
                        params=jax.tree_util.tree_map(np.asarray,
                                                      jax_run.params))
    assert jax_run._steps_per_dispatch() == port_run._steps_per_dispatch() \
        == 4
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        **TABLE_TOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_row_update_lr_tensor_equals_float(optimizer):
    """K3's plain version (and its wrapper on CPU tensors) with a host
    float lr and with a 0-d float32 tensor: the same bits, both equal to
    ``float32(-lr)`` times the update."""
    rng = np.random.default_rng(5)
    V, R, D = 50, 12, 7
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ssum = torch.from_numpy(rng.uniform(0, 2, (V, D)).astype(np.float32))
    uniq = torch.from_numpy(np.sort(rng.choice(V, R, replace=False)))
    rows_g = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    lr = 0.1 / 3  # not a float32
    buffer = torch.tensor([0.5, lr], dtype=torch.float32)
    results = []
    for rate in (lr, buffer[1]):
        for call in ("reference", "wrapper"):
            t, s = table.clone(), ssum.clone()
            group = (t, s if optimizer == "adagrad" else None, uniq, rows_g,
                     rate, 1e-10)
            if call == "reference":
                ru.row_update_groups_reference(optimizer, [group])
            else:
                ru.row_update_groups(optimizer, [group])
            results.append((t, s))
    for t, s in results[1:]:
        assert torch.equal(t, results[0][0])
        assert torch.equal(s, results[0][1])
    if optimizer == "sgd":
        want = table.numpy().copy()
        want[uniq.numpy()] += np.float32(-lr) * rows_g.numpy()
        np.testing.assert_array_equal(results[0][0].numpy(), want)


# ----------------------------------------------------------------- capture


def reasons(job):
    """The job's reasons, after ``_prepare`` (which sets the strategy's
    options, graph sampling among them)."""
    job._prepare()
    return job._capture_unsupported_reasons()


def test_capture_takes_dropout_state_and_row_sparse_steps(tmp_path):
    conve = conve_job(tmp_path, "conve")
    assert conve.model.model_state
    assert conve.config.get("conve.projection_dropout") > 0
    assert reasons(conve) == []
    embedder_dropout = port_job({"lookup_embedder.dropout": 0.1})
    assert reasons(embedder_dropout) == []
    sparse = port_job({**SPARSE, "tpu.fused_negsamp_loss": "always"})
    assert sparse._sparse_paths == TABLES
    assert reasons(sparse) == []


def toy_compgcn_job(**options):
    """``examples/toy-transe-compgcn-train.yaml`` on the CPU."""
    config = Config(folder=None)
    config.load(os.path.join(REPO, "examples",
                             "toy-transe-compgcn-train.yaml"))
    for key, value in {"job.device": "cpu", "console.quiet": True,
                       **options}.items():
        config.set(key, value)
    return TrainingJob.create(config, Dataset.create(config, TOY))


def test_capture_still_refuses_rgnn_mesh_and_graph_sampling(tmp_path):
    """An R-GNN encoder on a fixed graph is captured; graph sampling and
    a device mesh keep their reasons, with an encoder or without."""
    rgnn = toy_compgcn_job()
    assert reasons(rgnn) == []
    rgnn.mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    assert any("device mesh" in r for r in reasons(rgnn))
    rgnn_sampled = toy_compgcn_job(**{
        "negative_sampling.graph_sampling": "uniform",
        "negative_sampling.graph_sampling_size": 200})
    assert any("graph sampling" in r for r in reasons(rgnn_sampled))
    sampled = port_job({"negative_sampling.graph_sampling": "uniform",
                        "negative_sampling.graph_sampling_size": 200})
    assert any("graph sampling" in r for r in reasons(sampled))
    mesh = port_job({})
    assert reasons(mesh) == []
    mesh.mesh = SimpleNamespace(shape={"data": 2, "model": 1})
    assert any("device mesh" in r for r in reasons(mesh))


class StandInGraph:
    """A captured graph's stand-in on the CPU: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def standing_in(job, k: int = 4, launches=((ccorr_reduce, 24),)):
    """``job`` dispatches as on a card, each capture a stand-in graph of
    ``k`` steps that recorded ``launches``; returns the keys captured."""
    captured = []

    def capture(key, host, run):
        out = torch.zeros(k, 1)
        job._graphs[key] = _Graph(StandInGraph(), {}, ["avg_loss"], out,
                                  list(launches))
        captured.append(key)
        return ["avg_loss"], out.clone()

    job._capture = True
    job._capture_group = capture
    return captured


def test_replay_counts_launches_batches_and_its_span():
    """The spectral route's reduce is a counted kernel: a replay adds the
    launches its capture recorded (6 a step, 4 steps), counts its 4
    batches in ``replayed_batches`` and runs in ``train.replay``."""
    assert ccorr_reduce in COUNTED_KERNELS
    job = toy_compgcn_job()
    captured = standing_in(job)
    before = ccorr_reduce.launches
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                names, out = job._dispatch_group("key", {}, None)
                assert names == ["avg_loss"] and tuple(out.shape) == (4, 1)
        assert ccorr_reduce.launches - before == 2 * 24
    finally:
        ccorr_reduce.launches = before
    assert captured == ["key"]
    assert job._graphs["key"].graph.replays == job.graph_replays == 2
    assert job.replayed_batches == 8
    spans = [e for e in prof.events() if e.name == "train.replay"]
    assert len(spans) == 2


@pytest.mark.parametrize("rebuild", ["set_graph", "halo"])
def test_rebuilt_encoder_graph_drops_captured_groups(rebuild):
    """A graph replays the tensors bound when it was captured: after
    ``set_graph`` (graph sampling's rebuild) or ``prepare_job``'s halo
    rebuild under a model axis, the next group is captured anew; an
    unchanged graph keeps its groups."""
    job = toy_compgcn_job()
    captured = standing_in(job)
    job._dispatch_group("a", {}, None)
    job._dispatch_group("b", {}, None)
    job._dispatch_group("a", {}, None)
    assert captured == ["a", "b"] and job.graph_replays == 1
    version = job.model.graph_version
    if rebuild == "set_graph":
        job.model.set_graph(None)
    else:
        job.model.encoder.prepare_job(SimpleNamespace(mesh=SimpleNamespace(
            shape={"data": 1, "model": 2}, model_index=0,
            group=lambda name: None)))
    assert job.model.graph_version == version + 1
    job._dispatch_group("a", {}, None)
    assert captured == ["a", "b", "a"] and set(job._graphs) == {"a"}
    job._dispatch_group("a", {}, None)
    assert captured == ["a", "b", "a"] and job.graph_replays == 2


# ----------------------------------------------------------------- on a card

#: R-GNN jobs a card captures, on data/toy with every dropout on: CompGCN
#: on the spectral route (ccorr) with batch-norm state and a reciprocal
#: ConvE by KvsAll; RAGAT's attention softmax and R-GCN's block
#: decomposition by negative sampling
RGNN_CAPTURED = {
    "compgcn-ccorr-conve-kvsall": COMPGCN_CONVE,
    "ragat-attention": (ROUTES["attention"][0], {**ROUTES["attention"][1],
                                                 **NEGATIVE_SAMPLING}),
    "rgcn-blocks": ("rgcn", {
        **rgnn_options("rgcn", weight_decomposition="block",
                       num_blocks_or_bases=2),
        "rgcn.decoder.model": "distmult", "rgcn.decoder.type": "distmult",
        **NEGATIVE_SAMPLING}),
}


def card_rgnn_job(case, folder, **extra):
    return rgnn_make_job(RGNN_CAPTURED[case], folder, **{
        "job.device": "cuda", "train.max_epochs": 2,
        "train.trace_level": "batch", **GROUP, **extra})


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RGNN_CAPTURED))
def test_rgnn_captured_groups_equal_per_batch_steps(case, tmp_path,
                                                    monkeypatch):
    """On a card, 2 epochs in captured groups of 4 and the same batches one
    eager step at a time give the same epoch and batch losses, dropout
    generator state, parameters, Adam state and model state, bit for bit;
    a captured run resumed after epoch 1 equals the uninterrupted one; the
    groups replay, and the spectral route's reduce counts 6 launches a
    step through the replays. Under deterministic algorithms: the
    encoder's and the embeddings' gradients are summed with atomics
    otherwise, and two eager runs part in the last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured steps run on a card)")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs, losses, launches = {}, {}, {}
        for label, k in (("captured", 4), ("per-batch", 1)):
            job = card_rgnn_job(case, tmp_path / label,
                                **{"tpu.steps_per_dispatch": k})
            if k == 1 and job.config.get("train.type") == "KvsAll":
                in_group_order(job, 4)
            losses[label] = record_epochs(job)
            before = ccorr_reduce.launches
            job.run()
            torch.cuda.synchronize()
            launches[label] = ccorr_reduce.launches - before
            runs[label] = job
        cut = card_rgnn_job(case, tmp_path / "cut", **{
            "train.max_epochs": 1, "train.checkpoint.every": 1})
        cut.run()
        resumed = Job.create_from(
            load_checkpoint(cut.config.checkpoint_file(1)),
            dataset=cut.dataset)
        resumed.config.set("train.max_epochs", 2)
        resumed_losses = record_epochs(resumed)
        resumed.run()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    captured, per_batch = runs["captured"], runs["per-batch"]
    assert captured._capture and captured.graph_replays > 0
    assert 0 < captured.replayed_batches <= captured.current_trace[
        "epoch"]["batches"]
    assert per_batch.graph_replays == 0
    assert len(losses["captured"]) == 2
    assert losses["captured"] == losses["per-batch"]
    assert batch_losses(captured) == batch_losses(per_batch)
    assert torch.equal(captured._dropout_gen.get_state(),
                       per_batch._dropout_gen.get_state())
    assert_same_run(captured, per_batch)
    assert resumed.graph_replays > 0
    assert resumed_losses == losses["captured"][1:]
    assert_same_run(captured, resumed)
    steps = len(batch_losses(captured))
    if case.startswith("compgcn"):
        assert captured.model.model_state
        assert launches["captured"] == launches["per-batch"] == 6 * steps
    else:
        assert launches["captured"] == launches["per-batch"] == 0


def signature(batch):
    """A host batch's structure, as the epoch loop groups batches."""
    return tuple((key, np.shape(v), str(np.asarray(v).dtype))
                 for key, v in sorted(batch.items()))


@pytest.mark.cuda
def test_capture_after_a_profiled_eager_step(tmp_path):
    """Under a profiler, with the garbage collector off: one eager step
    on the default stream (its encoder's backward hooked for the span),
    then 8 batches of another structure, a capture and a replay. The
    eager step's hooks must not keep its graph: the leaves' gradient
    accumulators it made on the default stream would be reused by the
    capture and fail it (``cudaErrorStreamCaptureImplicit``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured steps run on a card)")
    job = card_rgnn_job("compgcn-ccorr-conve-kvsall", tmp_path)
    job._prepare()
    job._is_prepared = True
    job.epoch = 1
    batches = list(job._generate_batches(1))
    first = signature(batches[0])
    group = [b for b in batches if signature(b) != first][:8]
    assert len(group) == 8
    job._generate_batches = lambda epoch: iter([batches[0]] + group)
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            job.run_epoch()
            torch.cuda.synchronize()
    finally:
        gc.enable()
    assert job._capture and len(job._graphs) == 1
    assert job.graph_replays == 1 and job.replayed_batches == 4
    # the host's spans (each also has an annotation on the device)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("train.encode.backward") >= 1
    assert names.count("train.replay") == 1
