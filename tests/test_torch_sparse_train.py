"""Row-sparse training (``tpu.sparse_updates``) in the port against
kge_tpu's on data/toy: both run with ``always``, the same seed, and the
JAX job's initial weights carried into the port; the cases are those of
tests/test_sparse_updates.py with the ``batch`` scoring implementation
(``triple``: tests/test_torch_negsamp_modes.py).

Tolerances as for the dense trajectories (tests/test_torch_train.py): the
first step's loss rtol 1e-6, each epoch's avg_loss rtol 1e-5, Adagrad's
tables atol 1e-4 (its first update of an element is about lr * sign(g),
so a gradient at rounding-noise size can flip between summation orders)
or 1e-6 with ``initial_accumulator_value`` 0.1, SGD's tables 1e-6 (SGD is
linear in g: only the summation order differs).
"""

import os

import jax
import numpy as np
import pytest
import torch

from kge_tpu_torch.ops import row_update as ru
from tests.test_torch_train import (
    assert_tables_close, first_batch_loss, jax_job, jax_tables, port_job,
    port_tables, record_epochs,
)

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

TABLES = ("entity_embedder.weights", "relation_embedder.weights")

#: tests/test_sparse_updates.py's setting (its _run_training)
SPARSE = {
    "tpu.sparse_updates": "always", "tpu.sparse_row_kernel": "never",
    "negative_sampling.num_samples.s": 5,
    "negative_sampling.num_samples.o": 7,
    "train.optimizer.default.args.lr": 0.1, "random_seed.default": 11,
    "lookup_embedder.regularize": "lp",
    "lookup_embedder.regularize_weight": 0.01,
    "lookup_embedder.regularize_args.weighted": True,
    "train.trace_level": "batch",
}
CASES = {
    "adagrad-shared-batch-fused": {"tpu.fused_negsamp_loss": "always"},
    "adagrad-shared-batch-unfused": {"tpu.fused_negsamp_loss": "never"},
    "adagrad-shared-batch-accumulator": {
        "tpu.fused_negsamp_loss": "always",
        "train.optimizer.default.args.initial_accumulator_value": 0.1},
    "adagrad-not-shared-batch": {"negative_sampling.shared": False},
    "sgd-not-shared-batch": {
        "negative_sampling.shared": False,
        "train.optimizer.default.type": "SGD",
        "lookup_embedder.regularize_weight": 0.0},
}


def table_tolerance(name):
    if name.startswith("sgd") or name.endswith("accumulator"):
        return dict(rtol=1e-6, atol=1e-6)
    return dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_trajectory_matches_kge_tpu(name, tmp_path):
    options = {**SPARSE, **CASES[name]}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(
        options, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    assert jax_run._sparse_paths == port_run._sparse_paths == TABLES
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        **table_tolerance(name))


@pytest.mark.parametrize("optimizer", ["Adagrad", "SGD"])
def test_sparse_matches_dense(optimizer):
    """The port's sparse and dense runs of one configuration."""
    runs = {}
    for mode in ("always", "never"):
        job = port_job({**SPARSE, "tpu.sparse_updates": mode,
                        "tpu.fused_negsamp_loss": "always",
                        "train.optimizer.default.type": optimizer,
                        "train.trace_level": "epoch"})
        losses = record_epochs(job)
        job.run()
        runs[mode] = (losses, port_tables(job), job)
    assert runs["always"][2]._sparse_paths == TABLES
    assert runs["never"][2]._sparse_paths == ()
    np.testing.assert_allclose(runs["always"][0], runs["never"][0],
                               rtol=1e-6)
    assert_tables_close(runs["always"][1], runs["never"][1],
                        rtol=1e-6, atol=1e-6)


def test_sparse_step_leaves_no_table_gradient():
    """The tables take no part in autograd: after a step their .grad is
    None, their Adagrad sums changed only in the touched rows, and the
    CPU run took the plain row updates (no kernel launch counted)."""
    job = port_job({**SPARSE, "train.max_epochs": 1,
                    "tpu.fused_negsamp_loss": "always"})
    job._prepare()
    job._is_prepared = True
    job.epoch = 1
    batch_np = next(job._generate_batches(1))
    sums = {k: v.clone() for k, v in job.opt_state["sum"].items()}
    launches = (ru.adagrad_row_update.launches, ru.sgd_row_update.launches)
    job._step(job._put_batch(batch_np),
              {g: 0.1 for g in job.optimizer.base_lrs})
    for name, p in job.model.named_parameters():
        assert not p.requires_grad and p.grad is None, name
    touched = {"entity_embedder.weights": batch_np["uniq_e"],
               "relation_embedder.weights": batch_np["uniq_r"]}
    for name, ids in touched.items():
        changed = (job.opt_state["sum"][name] != sums[name]).any(
            dim=1).numpy()
        assert changed.any() and set(np.flatnonzero(changed)) <= set(ids)
    assert (ru.adagrad_row_update.launches,
            ru.sgd_row_update.launches) == launches == (0, 0)


@pytest.mark.parametrize("optimizer", ["Adagrad", "SGD"])
def test_sparse_step_updates_both_tables_in_one_call(optimizer):
    """A row-sparse step hands both tables to one ``sparse_row_update``
    call (one kernel launch on a card), each with its touched ids."""
    job = port_job({**SPARSE, "train.max_epochs": 1,
                    "tpu.fused_negsamp_loss": "always",
                    "train.optimizer.default.type": optimizer})
    job._prepare()
    job._is_prepared = True
    job.epoch = 1
    calls = []
    update = job.optimizer.sparse_row_update

    def recorded(state, rows, lrs):
        calls.append({name: uniq.clone() for name, (uniq, _) in rows.items()})
        update(state, rows, lrs)

    job.optimizer.sparse_row_update = recorded
    batch_np = next(job._generate_batches(1))
    job._step(job._put_batch(batch_np),
              {g: 0.1 for g in job.optimizer.base_lrs})
    assert len(calls) == 1 and tuple(calls[0]) == TABLES
    for name, key in zip(TABLES, ("uniq_e", "uniq_r")):
        np.testing.assert_array_equal(calls[0][name].numpy(), batch_np[key])


def test_row_index_payload():
    """Sorted distinct ids of exactly the bound's size, fill ids from the
    top of the padded vocabulary, and the batch's indexes remapped so
    that uniq[remapped] gives back the original ids."""
    job = port_job({**SPARSE, "negative_sampling.shared": True})
    job._prepare()
    plain = port_job({**SPARSE, "tpu.sparse_updates": "never"})
    plain._prepare()
    for sparse, dense in zip(job._generate_batches(1),
                             plain._generate_batches(1)):
        ue, ur = sparse["uniq_e"], sparse["uniq_r"]
        e_pad = job.model.get_s_embedder().padded_vocab_size
        r_pad = job.model.get_p_embedder().padded_vocab_size
        ent_rows, rel_rows = job._touched_row_counts()
        assert len(ue) == min(ent_rows, e_pad)
        assert len(ur) == min(rel_rows, r_pad)
        for u, pad in ((ue, e_pad), (ur, r_pad)):
            assert (np.diff(u) > 0).all() and u[0] >= 0 and u[-1] < pad
        t = sparse["triples"]
        np.testing.assert_array_equal(
            np.stack([ue[t[:, 0]], ur[t[:, 1]], ue[t[:, 2]]], axis=1),
            dense["triples"])
        for key in ("s", "o"):
            np.testing.assert_array_equal(ue[sparse[f"neg_unique_{key}"]],
                                          dense[f"neg_unique_{key}"])
            np.testing.assert_array_equal(sparse[f"neg_gather_{key}"],
                                          dense[f"neg_gather_{key}"])


def test_auto_stays_dense_on_toy_and_logs_why(tmp_path):
    job = port_job({**SPARSE, "tpu.sparse_updates": "auto"},
                   str(tmp_path / "port"))
    assert job._sparse_paths == ()
    assert all(p.requires_grad for p in job.model.parameters())
    with open(os.path.join(job.config.folder, "kge.log")) as f:
        log = f.read()
    assert ("Row-sparse updates not applicable: entity vocabulary too "
            "small for sparse updates to pay") in log


def test_workaround_options_are_logged_as_ignored(tmp_path):
    job = port_job({**SPARSE, "tpu.sparse_table_chunks": "3",
                    "tpu.sparse_row_kernel": "always"},
                   str(tmp_path / "port"))
    assert job._sparse_paths == TABLES
    with open(os.path.join(job.config.folder, "kge.log")) as f:
        log = f.read()
    # they change no number; as in kge_tpu they set the steps a dispatch
    for key in ("tpu.sparse_table_chunks", "tpu.sparse_row_kernel"):
        assert f"{key} sets the steps a dispatch only" in log
    assert "tpu.sparse_split_phases sets" not in log


@pytest.mark.parametrize("options", [
    {"lookup_embedder.regularize_args.weighted": False},
    {"train.optimizer.default.args.weight_decay": 0.01},
    {"train.optimizer.default.type": "SGD",
     "train.optimizer.default.args.momentum": 0.9},
    {"train.subbatch_size": 8},
], ids=["unweighted-regularization", "weight-decay", "sgd-momentum",
        "subbatch"])
def test_always_raises_with_kge_tpus_reasons(options):
    options = {**SPARSE, **options}
    with pytest.raises(ValueError, match="not applicable") as want:
        jax_job(options)
    with pytest.raises(ValueError, match="not applicable") as got:
        port_job(options)
    assert str(got.value) == str(want.value)


def test_dense_sgd_matches_kge_tpu(tmp_path):
    """Plain SGD without row-sparse updates (its dense step) against
    kge_tpu's, with a weight decay that row-sparse updates refuse."""
    options = {"train.optimizer.default.type": "SGD",
               "train.optimizer.default.args.weight_decay": 0.01,
               "tpu.sparse_updates": "never", "train.trace_level": "batch",
               "tpu.fused_negsamp_loss": "always"}
    jax_run = jax_job(options, str(tmp_path / "jax"))
    port_run = port_job(
        options, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    assert port_run.opt_state == {}
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("options", [
    {"train.optimizer.default.args.momentum": 0.9},
    {"train.optimizer.default.args.momentum": 0.9,
     "train.optimizer.default.args.nesterov": True},
], ids=["momentum", "nesterov"])
def test_sgd_momentum_is_not_yet_ported(options, tmp_path):
    """SGD with momentum (and Nesterov's form of it) is ported: its dense
    trajectory matches kge_tpu's (tables 1e-6, SGD being linear in g), and
    row-sparse updates refuse it with kge_tpu's error."""
    options = {"train.optimizer.default.type": "SGD",
               "train.optimizer.default.args.lr": 0.1,
               "train.trace_level": "batch",
               "tpu.fused_negsamp_loss": "always", **options}
    dense = {**options, "tpu.sparse_updates": "never"}
    jax_run = jax_job(dense, str(tmp_path / "jax"))
    port_run = port_job(
        dense, str(tmp_path / "port"),
        params=jax.tree_util.tree_map(np.asarray, jax_run.params))
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    assert set(port_run.opt_state) == {"trace"}
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_tables_close(port_tables(port_run), jax_tables(jax_run),
                        rtol=1e-6, atol=1e-6)
    sparse = {**SPARSE, **options}
    with pytest.raises(ValueError, match="SGD momentum decays") as want:
        jax_job(sparse)
    with pytest.raises(ValueError, match="SGD momentum decays") as got:
        port_job(sparse)
    assert str(got.value) == str(want.value)
