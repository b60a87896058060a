"""On-device negative sampling and the grouped, device-resident epoch of
kge_tpu_torch (``train/sampler.py:device_shared_sample``,
``train/train.py``, ``train/train_negative_sampling.py``) against
kge_tpu on data/toy, on the CPU (where each group's steps run eagerly).

The torch and JAX PRNG streams differ, so the device draws are held to
``kge_tpu``'s by their distribution (chi-square p-values of seeded
draws, at least ``P_MIN``; the mean number of distinct negatives within
3 standard errors of its expectation), and everything else by equality:
the draws' structure exactly, the epoch payload exactly, the first step
on ``kge_tpu``'s own draws within 1e-6 relative (tables within
``TABLE_TOL``, Adagrad's sign trap), and within the port grouped against
per-batch steps, prefetch against serial and resume against
uninterrupted bit for bit.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.stats import chi2_contingency

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.train.sampler import (
    device_shared_sample as jax_device_shared_sample,
)
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.ops.negsamp_loss import expand_counts
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.sampler import device_shared_sample
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_train import (
    TABLE_TOL, TOY, assert_tables_close, jax_job, jax_tables, make_config,
    port_job, port_tables, record_epochs,
)

torch.set_num_threads(1)

#: negatives drawn on the device, 4 steps a dispatch (the fused loss is
#: kge_tpu's route only on an accelerator under auto, so it is forced)
ON_DEVICE = {"tpu.fused_negsamp_loss": "always",
             "tpu.on_device_sampling": "always",
             "tpu.steps_per_dispatch": 4}
#: a chi-square p-value below this fails (the draws are seeded)
P_MIN = 1e-3


def _sharing(naive):
    return "naive" if naive else "default"


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("num", [1, 3, 128])
@pytest.mark.parametrize("with_replacement", [True, False],
                         ids=["wr", "wor"])
@pytest.mark.parametrize("naive", [False, True], ids=_sharing)
def test_device_sample_structure(naive, with_replacement, num):
    """Every draw: distinct in-range uniques, positions at and past
    ``take`` repeating unique[0], ``base`` summing to num and 0 from
    ``nu`` on, every drawn positive dropped at its position, and
    ``expand_counts``' rows holding the num draws, the dropped position's
    mass moved to the extra candidate."""
    voc, rows = 300, 64
    generator = torch.Generator().manual_seed(num)
    positives_rng = np.random.default_rng(num)
    hits = 0
    for _ in range(20):
        positives = torch.from_numpy(positives_rng.integers(0, voc, rows))
        unique, base, nu, drop = device_shared_sample(
            generator, num, voc, naive, with_replacement, positives)
        assert unique.shape == base.shape == (num + 1,)
        assert unique.dtype == torch.int64 and base.dtype == torch.float32
        nu = int(nu)
        assert 1 <= nu <= num and (with_replacement or nu == num)
        take = nu if naive else nu + 1
        live = unique[:take].numpy()
        assert len(set(live)) == take and live.min() >= 0 and live.max() < voc
        assert (unique[take:] == unique[0]).all()
        assert float(base.sum()) == num
        assert (base[nu:] == 0).all() and (base[:nu] >= 1).all()
        counts = expand_counts(base, torch.tensor(nu), drop, rows)
        assert (counts.sum(dim=1) == num).all()
        if naive:
            assert drop is None
            assert (counts == base).all()
            continue
        assert drop.shape == (rows,) and drop.min() >= 0 and drop.max() <= nu
        for b in range(rows):
            where = np.flatnonzero(live == int(positives[b]))
            if len(where):
                hits += 1
                assert int(drop[b]) == where[0]
            # the dropped position's mass moves to the extra candidate
            d = int(drop[b])
            assert counts[b, d] == 0 or d == nu
            assert counts[b, nu] == (base[d] if d < nu else 0)
    if not naive and num == 128:
        assert hits > 0  # the positive-drop trick was exercised


# ------------------------------------------------------------------ (b)


def _two_sample_p(a: np.ndarray, b: np.ndarray) -> float:
    """p-value of the chi-square test that two histograms come from one
    distribution, bins merged in order until each pair holds 10 draws."""
    rows, acc = [], np.zeros(2)
    for pair in zip(a, b):
        acc += pair
        if acc.sum() >= 10:
            rows.append(acc)
            acc = np.zeros(2)
    if acc.sum() and rows:
        rows[-1] = rows[-1] + acc
    if len(rows) < 2:
        return 1.0
    return float(chi2_contingency(np.asarray(rows).T)[1])


def _histograms(unique, nu, drop, num, voc, naive):
    """nu's histogram, the live uniques' ids, the dropped positions."""
    nu = np.asarray(nu).astype(np.int64)
    take = nu if naive else nu + 1
    unique = np.asarray(unique)
    live = np.arange(num + 1)[None, :] < take[:, None]
    ids = np.bincount(unique[live], minlength=voc)
    drops = (np.zeros(num + 1) if drop is None else
             np.bincount(np.asarray(drop).reshape(-1), minlength=num + 1))
    return np.bincount(nu, minlength=num + 1), ids, drops, nu


@pytest.mark.parametrize("with_replacement", [True, False],
                         ids=["wr", "wor"])
@pytest.mark.parametrize("naive", [False, True], ids=_sharing)
def test_device_sample_distribution_matches_kge_tpu(naive, with_replacement):
    """3,000 seeded draws at voc 50, num 20 from the port and from
    kge_tpu's ``device_shared_sample`` (JAX on the CPU): the histograms
    of nu, of the live uniques' ids and of the dropped positions agree
    (two-sample chi-square p >= P_MIN), and each package's mean nu lies
    within 3 standard errors of base_voc * (1 - (1 - 1/base_voc)^num)."""
    draws, num, voc = 3000, 20, 50
    positives = np.arange(8) * 6
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    sample = jax.jit(jax.vmap(lambda k: jax_device_shared_sample(
        k, num, voc, naive, with_replacement, jnp.asarray(positives))))
    j_unique, _, j_nu, j_drop = sample(keys)
    generator = torch.Generator().manual_seed(0)
    p_unique, p_nu, p_drop = [], [], []
    for _ in range(draws):
        unique, _, nu, drop = device_shared_sample(
            generator, num, voc, naive, with_replacement,
            torch.from_numpy(positives))
        p_unique.append(unique.numpy())
        p_nu.append(int(nu))
        p_drop.append(None if drop is None else drop.numpy())
    port = _histograms(np.stack(p_unique), p_nu,
                       None if naive else np.stack(p_drop), num, voc, naive)
    ref = _histograms(j_unique, j_nu, None if naive else j_drop, num, voc,
                      naive)
    for name, got, want in zip(("nu", "ids", "drop"), port[:3], ref[:3]):
        assert _two_sample_p(got, want) >= P_MIN, name
    base_voc = voc if naive else voc - 1
    if with_replacement:
        mean = base_voc * (1 - (1 - 1 / base_voc) ** num)
        for nus in (port[3], ref[3]):
            assert abs(nus.mean() - mean) <= 3 * nus.std() / math.sqrt(draws)
    else:
        assert (port[3] == num).all() and (ref[3] == num).all()


# ------------------------------------------------------------------ (c), (d)


def _prepared(job):
    job._prepare()
    job._is_prepared = True
    job.epoch = 1
    return job


def test_same_draws_give_kge_tpus_step():
    """kge_tpu's on-device batch (its draws) through the port's step: the
    first step's loss within 1e-6 relative and the tables after it within
    TABLE_TOL; the port expands the same positions into the same triples,
    weights and size."""
    jax_run = _prepared(jax_job(ON_DEVICE))
    port = _prepared(port_job(
        ON_DEVICE, params=jax.tree_util.tree_map(np.asarray, jax_run.params)))
    payload = jax_run._epoch_device_payload(1)
    port._epoch_device_payload(1)  # stages the train split on the device
    last = len(payload["size"]) - 1  # the tail: padded rows of weight 0
    rng = jax.random.PRNGKey(5)
    for j in (0, last):
        batch = {k: jnp.asarray(v[j]) for k, v in payload.items()}
        expanded = jax_run._expand_device_batch(batch, rng)
        mine = port._expand_device_batch(port._put_batch(
            {k: np.asarray(v) for k, v in batch.items()}))
        for key in ("triples", "weights", "size"):
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(expanded[key]))
    assert payload["size"][last] < 32
    batch = {k: jnp.asarray(v[0]) for k, v in payload.items()}
    expanded = jax_run._expand_device_batch(batch, rng)
    lrs = {g: jnp.asarray(base, dtype=jnp.float32)
           for g, base in jax_run.optimizer.base_lrs.items()}
    params, _, _, metrics = jax_run._make_step_fn()(
        jax_run.params, jax_run.opt_state, jax_run.model_state, expanded,
        lrs, rng)
    got = port._step(port._put_batch(
        {k: np.asarray(v) for k, v in expanded.items()}),
        dict(port.optimizer.base_lrs))
    np.testing.assert_allclose(float(got["avg_loss"]),
                               float(metrics["avg_loss"]), rtol=1e-6)
    want = {k: np.asarray(v["weights"]) for k, v in params.items()
            if "weights" in v}
    assert_tables_close(port_tables(port), want, **TABLE_TOL)


def test_epoch_payload_equals_kge_tpus():
    """The device-resident epoch payload ([M, B] positions, [M] sizes) is
    kge_tpu's exactly, epoch by epoch."""
    jax_run, port = _prepared(jax_job(ON_DEVICE)), _prepared(
        port_job(ON_DEVICE))
    for epoch in (1, 2):
        want = jax_run._epoch_device_payload(epoch)
        got = port._epoch_device_payload(epoch)
        assert set(got) == set(want) == {"pos_idx", "size"}
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert not np.array_equal(port._epoch_device_payload(1)["pos_idx"],
                              port._epoch_device_payload(2)["pos_idx"])


# ------------------------------------------------------------------ (e)


REASONS = {
    "applies": {},
    # the fused loss needs shared negatives: off in both packages
    "not-shared": {"negative_sampling.shared": False,
                   "tpu.fused_negsamp_loss": "never"},
    "not-uniform": {"negative_sampling.sampling_type": "frequency",
                    "negative_sampling.shared": False,
                    "tpu.fused_negsamp_loss": "never"},
    "off-fused-path": {"tpu.fused_negsamp_loss": "never"},
    "row-sparse": {"tpu.sparse_updates": "always",
                   "lookup_embedder.regularize_args.weighted": True},
    "graph-sampling": {"negative_sampling.graph_sampling": "uniform",
                       "negative_sampling.graph_sampling_size": 200},
    "small-vocabulary": {"negative_sampling.num_samples.o": 5000},
}


def _decision(make, options):
    """(decision, error message) of a job's ``_prepare``."""
    try:
        return _prepared(make(options))._on_device_sampling, None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("mode", ["auto", "always"])
@pytest.mark.parametrize("case", list(REASONS))
def test_on_device_decision_matches_kge_tpu(case, mode):
    """``_resolve_on_device_sampling`` decides as kge_tpu's does, for the
    same reasons: under auto the same decision, under always the same
    ValueError text."""
    options = {**ON_DEVICE, **REASONS[case],
               "tpu.on_device_sampling": mode}
    got, want = _decision(port_job, options), _decision(jax_job, options)
    assert got == want
    if case == "applies":
        assert got == (True, None)
    elif mode == "auto":
        assert got == (False, None)
    else:
        assert got[1].startswith(
            "tpu.on_device_sampling=always is not applicable here: ")


# ------------------------------------------------------------------ (f)


def _run(options, folder=None):
    job = port_job(options, folder)
    losses = record_epochs(job)
    job.run()
    return job, losses


def _assert_same_run(a, b):
    (job_a, losses_a), (job_b, losses_b) = a, b
    assert losses_a == losses_b
    for key, table in port_tables(job_a).items():
        np.testing.assert_array_equal(table, port_tables(job_b)[key],
                                      err_msg=key)
    for slot, tensors in job_a.opt_state.items():
        for name, value in tensors.items():
            np.testing.assert_array_equal(
                value.numpy(), job_b.opt_state[slot][name].numpy())


@pytest.mark.parametrize("optimizer", ["Adagrad", "Adam"])
def test_grouped_epoch_equals_per_batch_steps(optimizer):
    """On-device sampling with 4 steps a dispatch (the resident epoch in
    groups and a tail of one batch) gives the per-batch run bit for bit
    (kge_tpu's test_device_resident_epoch_invariance holds 1e-6); Adam's
    bias corrections go up with each group."""
    options = {**ON_DEVICE, "train.optimizer.default.type": optimizer}
    grouped = _run(options)
    assert grouped[0]._resident is not None
    assert grouped[0].num_examples % (32 * 4) != 0
    _assert_same_run(grouped, _run({**options, "tpu.steps_per_dispatch": 1}))


@pytest.mark.parametrize("sampling", ["always", "never"])
def test_prefetch_equals_serial(sampling):
    """A producer thread two batches deep draws and orders the batches
    as the serial loop does: the same run bit for bit, host-sampled in
    groups and on-device per batch."""
    options = {**ON_DEVICE, "tpu.on_device_sampling": sampling,
               "tpu.steps_per_dispatch": 4 if sampling == "never" else 1}
    _assert_same_run(_run({**options, "tpu.prefetch_batches": 2}),
                     _run({**options, "tpu.prefetch_batches": 0}))


def test_resume_equals_uninterrupted_run(tmp_path):
    """Negatives drawn on the device from a generator seeded per epoch: a
    run resumed after epoch 1 trains epoch 2 as the uninterrupted run
    does, bit for bit."""
    full = _run(ON_DEVICE, str(tmp_path / "full"))
    cut, _ = _run({**ON_DEVICE, "train.max_epochs": 1}, str(tmp_path / "cut"))
    resumed = Job.create_from(load_checkpoint(cut.config.checkpoint_file(1)),
                              dataset=cut.dataset)
    resumed.config.set("train.max_epochs", 2)
    losses = record_epochs(resumed)
    resumed.run()
    assert resumed.epoch == 2 and losses == full[1][1:]
    _assert_same_run((full[0], []), (resumed, []))


# ------------------------------------------------------------------ (g)


def test_epoch_loss_matches_kge_tpu_within_its_own_spread():
    """Epoch 1's avg_loss, the port against kge_tpu, both sampling on the
    device from the same initial weights, over 3 seeds: within twice the
    spread kge_tpu shows between its host-sampled and device-sampled
    runs over the same seeds (other draws, the same distribution)."""
    spread, apart = 0.0, 0.0
    for seed in (1, 2, 3):
        options = {**ON_DEVICE, "random_seed.default": seed,
                   "train.max_epochs": 1, "tpu.steps_per_dispatch": 1}
        device = jax_job(options)
        host = jax_job({**options, "tpu.on_device_sampling": "never"})
        port = port_job(options, params=jax.tree_util.tree_map(
            np.asarray, device.params))
        losses = [job.run()["avg_loss"] for job in (device, host, port)]
        spread = max(spread, abs(losses[0] - losses[1]))
        apart = max(apart, abs(losses[2] - losses[0]))
    assert 0 < spread and apart <= 2 * spread


# ------------------------------------------------------------------ (h), (i)


@pytest.mark.parametrize("sampling", ["always", "never"])
def test_batch_trace_level_with_grouped_dispatch(sampling, tmp_path):
    """train.trace_level batch under 4 steps a dispatch: one trace entry
    per real batch (kge_tpu's test of the same name), host-sampled groups
    and the resident epoch alike."""
    job, _ = _run({**ON_DEVICE, "tpu.on_device_sampling": sampling,
                   "train.trace_level": "batch", "train.max_epochs": 1},
                  str(tmp_path))
    with open(os.path.join(str(tmp_path), "trace.yaml")) as f:
        entries = [yaml.safe_load(line) for line in f]
    batches = [e for e in entries if e.get("scope") == "batch"]
    assert len(batches) == math.ceil(job.num_examples / 32)
    assert [e["batch"] for e in batches] == list(range(len(batches)))
    assert all(np.isfinite(e["avg_loss"]) for e in batches)
    epoch = [e for e in entries if e.get("event") == "epoch_completed"][0]
    sizes = [min(32, job.num_examples - 32 * i) for i in range(len(batches))]
    np.testing.assert_allclose(
        epoch["avg_loss"],
        sum(e["avg_loss"] * n for e, n in zip(batches, sizes)) / sum(sizes),
        rtol=1e-12)


def test_profile_dir_traces_epoch_one(tmp_path):
    """tpu.profile_dir: epoch 1 under torch.profiler, its Chrome trace in
    the folder (the training spans in it), and kge_tpu's log line."""
    profile_dir = str(tmp_path / "profile")
    job, _ = _run({**ON_DEVICE, "tpu.profile_dir": profile_dir},
                  str(tmp_path / "run"))
    assert os.listdir(profile_dir) == ["epoch_1.trace.json"]
    with open(os.path.join(profile_dir, "epoch_1.trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.forward", "train.backward", "train.optimizer"} <= names
    with open(os.path.join(str(tmp_path / "run"), "kge.log")) as f:
        assert f"Wrote device trace to {profile_dir}" in f.read()


# ------------------------------------------------------------------ (j)


@pytest.mark.parametrize("writer", ["kge_tpu", "port"])
def test_on_device_checkpoints_resume_in_both_packages(writer, tmp_path):
    """An on-device run's checkpoint after epoch 1 resumes in both
    packages, each sampling on the device: the weights and Adagrad sums
    loaded as written, and epoch 2 trained to a finite loss near the
    writer's own epoch 2 (other draws: within 5%)."""
    options = {**ON_DEVICE, "tpu.steps_per_dispatch": 1}
    make = jax_job if writer == "kge_tpu" else port_job
    full = make(options, str(tmp_path / "full"))
    want = record_epochs(full)
    full.run()
    cut = make({**options, "train.max_epochs": 1}, str(tmp_path / "cut"))
    cut.run()
    checkpoint_file = cut.config.checkpoint_file(1)
    stored = jax_load_checkpoint(checkpoint_file)
    tables = {k: v["weights"] for k, v in stored["model"]["params"].items()
              if "weights" in v}
    for package in ("jax", "port"):
        checkpoint = (jax_load_checkpoint if package == "jax"
                      else load_checkpoint)(checkpoint_file)
        checkpoint.pop("folder")
        config = (JaxConfig if package == "jax" else Config).create_from(
            checkpoint)
        config.set("train.max_epochs", 2)
        job = (JaxJob if package == "jax" else Job).create_from(
            checkpoint, new_config=config,
            dataset=(JaxDataset if package == "jax" else Dataset).create(
                make_config(config.__class__, options), TOY))
        assert job.epoch == 1
        loaded = (jax_tables(job) if package == "jax" else port_tables(job))
        assert_tables_close(loaded, tables, rtol=0, atol=0)
        losses = record_epochs(job)
        job.run()
        assert job.epoch == 2 and job._on_device_sampling
        assert np.isfinite(losses[0][0])
        np.testing.assert_allclose(losses[0][0], want[1][0], rtol=5e-2)

