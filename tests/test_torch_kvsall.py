"""The port's 1vsAll and KvsAll trainers (kge_tpu_torch/train/
train_{1vsall,kvsall}.py) against kge_tpu's on data/toy: ComplEx dim 16,
batch 32, two epochs, the same seed, and the JAX job's initial weights
carried into the port; KvsAll with the ``sp_`` and ``_po`` query types,
and with all three plus label smoothing 0.3; each at
``tpu.steps_per_dispatch`` 1 and 4 (4 regroups KvsAll's batch order);
KvsAll with bce, label smoothing and Adam; checkpoints of KvsAll with
Adam, of 1vsAll and of the default sampler crossing between the packages
both ways; an Adam run resumed equal to the uninterrupted run.

Tolerances as for negative sampling (tests/test_torch_train.py): the
batches equal kge_tpu's array for array, the first step's loss rtol
1e-6, each epoch's avg_loss rtol 1e-5, the tables ``TABLE_TOL``
(Adagrad's and Adam's first update of an element is about lr * sign(g)).
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_train import (
    TABLE_TOL, _resume_both, assert_tables_close, first_batch_loss, jax_job,
    jax_tables, port_job, port_tables, record_epochs,
)

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

CASES = {
    # the penalty of a 1vsAll batch takes its triples (the weighted form)
    "1vsAll": {"train.type": "1vsAll",
               "lookup_embedder.regularize_weight": 0.01,
               "lookup_embedder.regularize_args.weighted": True},
    "KvsAll": {"train.type": "KvsAll"},
    # KvsAll's penalty has no triples: the unweighted form
    "KvsAll-all-types-smoothed": {
        "train.type": "KvsAll", "KvsAll.query_types.s_o": True,
        "KvsAll.label_smoothing": 0.3,
        "lookup_embedder.regularize_weight": 0.01},
}
#: the path of chip_smoke.py's KvsAll phase: bce, smoothing, Adam
ADAM_BCE = {"train.type": "KvsAll", "train.loss": "bce",
            "KvsAll.label_smoothing": 0.1,
            "train.optimizer.default.type": "Adam",
            "train.optimizer.default.args.lr": 0.01,
            "tpu.steps_per_dispatch": 4}


def assert_batches_equal(jax_run, port_run, epochs=(1, 2)):
    for job in (jax_run, port_run):
        job._prepare()
        job._is_prepared = True
    assert port_run.num_examples == jax_run.num_examples
    for epoch in epochs:
        want = list(jax_run._generate_batches(epoch))
        got = list(port_run._generate_batches(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(w[key]),
                                              err_msg=key)
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype


def assert_counted_every_step(job):
    """Adam's step count, one per group, went on through every epoch."""
    steps = job.epoch * job.current_trace["epoch"]["batches"]
    assert [int(c) for c in job.opt_state["count"].values()] == [steps] * len(
        job.optimizer.group_names)


def run_both(options, tmp_path):
    options = {**options, "train.trace_level": "batch"}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(
        options, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    assert_batches_equal(jax_run, port_run)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    groups = []
    dispatch = port_run._dispatch_group
    port_run._dispatch_group = lambda key, host, run: (
        groups.append(key), dispatch(key, host, run))[1]
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        **TABLE_TOL)
    # the regrouped batches dispatch in groups of 4 of one structure (on
    # the host each group's steps run eagerly, the same math)
    if options["tpu.steps_per_dispatch"] > 1:
        assert groups and all(k == 4 for _, k in groups)
    else:
        assert not groups
    return jax_run, port_run


@pytest.mark.parametrize("steps_per_dispatch", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_kge_tpu(name, steps_per_dispatch, tmp_path):
    run_both({**CASES[name], "tpu.steps_per_dispatch": steps_per_dispatch},
             tmp_path)


def test_kvsall_bce_adam_matches_kge_tpu(tmp_path):
    _, port_run = run_both(ADAM_BCE, tmp_path)
    assert_counted_every_step(port_run)


def test_regrouped_order_runs_of_one_shape():
    """With steps_per_dispatch 4 the epoch's batches come in runs of at
    most 4 of one query type and label width, and they are the batches of
    steps_per_dispatch 1, reordered."""
    runs = {}
    for group in (1, 4):
        job = port_job({**CASES["KvsAll"], "tpu.steps_per_dispatch": group})
        job._prepare()
        runs[group] = list(job._generate_batches(1))
    regrouped, plain = runs[4], runs[1]

    def shape(b):
        return ("qtype_sp" in b, b["label_coords"].shape[1])

    def key(b):
        return (shape(b), b["queries"].tobytes())

    assert sorted(map(key, regrouped)) == sorted(map(key, plain))

    def segments(batches):
        """Maximal stretches of consecutive batches of one shape."""
        return 1 + sum(shape(a) != shape(b)
                       for a, b in zip(batches, batches[1:]))

    per_shape = Counter(map(shape, plain))
    runs = sum(-(-n // 4) for n in per_shape.values())
    # the runs of 4 are shuffled against each other, so neighbouring runs
    # of one shape merge into one stretch: at most one stretch a run
    assert len(per_shape) <= segments(regrouped) <= runs
    assert segments(regrouped) < segments(plain)


def test_label_smoothing_auto_correct():
    """kge_tpu's corrections: a negative smoothing becomes 0, one at or
    below 1/num_entities is raised just above it."""
    on = {"train.type": "KvsAll", "train.auto_correct": True}
    job = port_job({**on, "KvsAll.label_smoothing": -0.5})
    assert job.label_smoothing == 0.0
    job = port_job({**on, "KvsAll.label_smoothing": 1e-5})
    assert job.label_smoothing == 1.0 / job.dataset.num_entities() + 1e-9
    with pytest.raises(ValueError, match="must be >= 0"):
        port_job({"train.type": "KvsAll", "KvsAll.label_smoothing": -0.5})
    with pytest.raises(ValueError, match="must exceed 1/num_entities"):
        port_job({"train.type": "KvsAll", "KvsAll.label_smoothing": 1e-5})


def test_duplicate_labels_add_and_padding_drops():
    """A label coordinate given twice counts twice (kge_tpu's scatter-add)
    and the out-of-range padding value lands in no label."""
    job = port_job({"train.type": "KvsAll", "train.loss": "se",
                    "train.max_epochs": 1})
    job._prepare()
    captured = {}
    loss = job.loss

    def spy(scores, labels, **kwargs):
        captured["labels"] = labels
        return loss(scores, labels, **kwargs)

    job.loss = spy
    num = job.dataset.num_entities()
    batch = {
        "queries": torch.tensor([[0, 0], [1, 1]] + [[0, 0]] * 30),
        "label_coords": torch.tensor([[3, 3, num, num], [5, num, num, num]]
                                     + [[num] * 4] * 30),
        "weights": torch.tensor([1.0, 1.0] + [0.0] * 30),
        "size": 2.0,
        "qtype_sp": torch.zeros(0, dtype=torch.long),
    }
    job._subbatch_loss(job._step_context(batch)[0], batch, slice(0, 32))
    labels = captured["labels"]
    assert labels.shape == (32, num)
    assert float(labels[0, 3]) == 2.0 and float(labels[1, 5]) == 1.0
    assert float(labels.sum()) == 3.0


#: the runs whose checkpoints cross between the packages: KvsAll with
#: bce and Adam, 1vsAll, and the default sampler (``triple`` scoring)
CROSSING = {
    "kvsall-adam": ADAM_BCE,
    "1vsall": CASES["1vsAll"],
    "triple": {"negative_sampling.shared": False,
               "negative_sampling.implementation": "auto",
               "negative_sampling.num_samples.s": 3,
               "negative_sampling.num_samples.o": -1},
}


@pytest.mark.parametrize("writer", ["kge_tpu", "port"])
@pytest.mark.parametrize("kind", list(CROSSING))
def test_checkpoints_cross_over(kind, writer, tmp_path):
    """A checkpoint after epoch 1, written by either package, resumes in
    both to the same epoch-2 loss and tables."""
    options = {**CROSSING[kind], "train.max_epochs": 1}
    make = jax_job if writer == "kge_tpu" else port_job
    run = make(options, str(tmp_path / writer))
    run.run()
    jax_dataset = (run.dataset if writer == "kge_tpu"
                   else jax_job(options).dataset)
    port_dataset = (run.dataset if writer == "port"
                    else port_job(options).dataset)
    j, p = _resume_both(run.config.checkpoint_file(1), jax_dataset,
                        port_dataset)
    assert_tables_close(port_tables(p), jax_tables(j), **TABLE_TOL)
    if kind == "kvsall-adam":
        assert_counted_every_step(p)


def test_adam_resume_reproduces_uninterrupted_run(tmp_path):
    options = {**ADAM_BCE, "train.checkpoint.every": 1}
    full = port_job(options, str(tmp_path / "full"))
    full.run()
    cut = port_job({**options, "train.max_epochs": 1}, str(tmp_path / "cut"))
    cut.run()
    resumed = Job.create_from(load_checkpoint(cut.config.checkpoint_file(1)),
                              dataset=cut.dataset)
    assert resumed.epoch == 1
    resumed.config.set("train.max_epochs", 2)
    resumed.run()
    a, b = port_tables(full), port_tables(resumed)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for slot, tensors in full.opt_state.items():
        for name, value in tensors.items():
            np.testing.assert_array_equal(
                value.numpy(), resumed.opt_state[slot][name].numpy(),
                err_msg=f"{slot} {name}")
