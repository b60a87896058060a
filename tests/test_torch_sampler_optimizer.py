"""The port's sampler, loss, optimizer and LR scheduler
(kge_tpu_torch/train/{sampler,loss,optimizer}.py) against kge_tpu's: a
sampler seeded alike draws identical arrays; Adagrad steps on the same
gradients agree; every scheduler gives the same lr_scale sequence; the
checkpointed optimizer state has kge_tpu's leaves in kge_tpu's order,
both ways; the kl loss agrees for index and matrix labels; what kge_tpu
refuses, the port refuses with the same error. (Every optimizer type:
tests/test_torch_optimizers.py; every loss: tests/test_torch_losses.py.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import KgeModel as JaxKgeModel
from kge_tpu.train.loss import KgeLoss as JaxKgeLoss
from kge_tpu.train.optimizer import (
    KgeLRScheduler as JaxKgeLRScheduler, KgeOptimizer as JaxKgeOptimizer,
)
from kge_tpu.train.sampler import KgeSampler as JaxKgeSampler
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.train.loss import KgeLoss
from kge_tpu_torch.train.optimizer import KgeLRScheduler, KgeOptimizer
from kge_tpu_torch.train.sampler import KgeSampler
from kge_tpu_torch.utils.params import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)
TOY = os.path.join(REPO, "data", "toy")


def configs(options):
    """(kge_tpu Config, port Config) with the same ComplEx options."""
    out = []
    for cls in (JaxConfig, Config):
        config = cls()
        config.folder = None
        config.set("model", "complex")
        config._import("complex")
        config.set("dataset.name", "toy")
        config.set("console.quiet", True)
        config.set("job.device", "cpu")
        for key, value in options.items():
            config.set(key, value, create=True)
        out.append(config)
    return out


# ------------------------------------------------------------------ sampler


@pytest.mark.parametrize("options", [
    {"negative_sampling.shared": True},
    {"negative_sampling.shared": True,
     "negative_sampling.with_replacement": False},
    {"negative_sampling.shared": True,
     "negative_sampling.shared_type": "naive"},
    {"negative_sampling.shared": True,
     "negative_sampling.shared_type": "naive",
     "negative_sampling.with_replacement": False},
    {"negative_sampling.shared": False},
], ids=["default-wr", "default-wor", "naive-wr", "naive-wor", "not-shared"])
def test_seeded_sampler_draws_identical_batches(options):
    options = {"negative_sampling.num_samples.s": 7,
               "negative_sampling.num_samples.p": 3,
               "negative_sampling.num_samples.o": 11, **options}
    jconfig, pconfig = configs(options)
    jsampler = JaxKgeSampler.create(jconfig, "negative_sampling",
                                    JaxDataset.create(jconfig, TOY))
    psampler = KgeSampler.create(pconfig, "negative_sampling",
                                 Dataset.create(pconfig, TOY))
    np.testing.assert_array_equal(psampler.num_samples, jsampler.num_samples)
    train = Dataset.create(pconfig, TOY).split("train")
    for sampler in (jsampler, psampler):
        sampler.seed((17, 2))
    for start in range(0, 96, 32):
        triples = train[start:start + 32].astype(np.int32)
        for slot in (0, 1, 2):
            j, p = jsampler.sample(triples, slot), psampler.sample(triples,
                                                                  slot)
            assert p.shared == j.shared
            if j.shared:
                assert p.num_unique == j.num_unique
                for name in ("unique", "repeat_indexes", "drop", "gather"):
                    if getattr(j, name) is None:
                        assert getattr(p, name) is None, name
                    else:
                        np.testing.assert_array_equal(
                            getattr(p, name), getattr(j, name), err_msg=name)
                np.testing.assert_array_equal(p.counts(), j.counts())
            np.testing.assert_array_equal(p.materialize(), j.materialize())


def test_unported_sampling_raises():
    """The sampler options that kge_tpu refuses, refused alike: filtering
    with shared sampling (at construction), the frequency sampler with
    shared sampling (when it samples)."""
    shared = {"negative_sampling.shared": True}
    for options, error, match in (
            ({"negative_sampling.filtering.o": True}, ValueError,
             "filtering is incompatible with shared sampling"),
            ({"negative_sampling.sampling_type": "frequency"},
             NotImplementedError, "does not support shared sampling")):
        jconfig, pconfig = configs({**shared, **options})
        with pytest.raises(error, match=match):
            JaxKgeSampler.create(jconfig, "negative_sampling",
                                 JaxDataset.create(jconfig, TOY)).sample(
                np.zeros((4, 3), dtype=np.int32), 0)
        with pytest.raises(error, match=match):
            KgeSampler.create(pconfig, "negative_sampling",
                              Dataset.create(pconfig, TOY)).sample(
                np.zeros((4, 3), dtype=np.int32), 0)


# ------------------------------------------------------------------ optimizer

RELATION_GROUP = {"train.optimizer.relation": {
    "regex": ".*relation_embedder.*", "args": {"lr": 0.05}}}


def models(options, seed=0):
    """kge_tpu params (numpy tree) and the port model holding them."""
    jconfig, pconfig = configs({"lookup_embedder.dim": 6, **options})
    jdataset = JaxDataset.create(jconfig, TOY)
    jmodel = JaxKgeModel.create(jconfig, jdataset)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    model = KgeModel.create(pconfig, Dataset.create(pconfig, TOY),
                            device=torch.device("cpu"),
                            init_for_load_only=True)
    model.load_params(tree)
    return jconfig, pconfig, tree, model


@pytest.mark.parametrize("options", [
    {"train.optimizer.default.args.lr": 0.2},
    {"train.optimizer.default.args.lr": 0.2,
     "train.optimizer.default.args.weight_decay": 0.01},
    {"train.optimizer.default.args.lr": 0.3,
     "train.optimizer.default.args.initial_accumulator_value": 0.1,
     **RELATION_GROUP},
], ids=["adagrad", "weight-decay", "relation-group"])
def test_adagrad_steps_match_kge_tpu(options):
    jconfig, pconfig, tree, model = models(options)
    jopt = JaxKgeOptimizer(jconfig, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = dict(model.named_parameters())
    opt = KgeOptimizer(pconfig, params)
    state = opt.init()
    assert opt.base_lrs == jopt.base_lrs
    rng = np.random.default_rng(4)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        scale = 0.5 ** step
        lrs = {g: base * scale for g, base in opt.base_lrs.items()}
        jparams, jstate = jopt.apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            {g: jnp.asarray(v, jnp.float32) for g, v in lrs.items()})
        for name, p in params.items():
            part, leaf = name.split(".")
            p.grad = torch.tensor(grads[part][leaf])
        opt.step(state, lrs)
    for name, p in params.items():
        part, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[part][leaf]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("options", [
    {},
    RELATION_GROUP,
    {"train.optimizer.default.args.weight_decay": 0.01, **RELATION_GROUP},
], ids=["one-group", "two-groups", "weight-decay"])
def test_opt_state_leaves_in_kge_tpu_order(options):
    jconfig, pconfig, tree, model = models(options)
    jstate = JaxKgeOptimizer(jconfig, tree).init(
        jax.tree_util.tree_map(jnp.asarray, tree))
    opt = KgeOptimizer(pconfig, dict(model.named_parameters()))
    state = opt.init()
    # distinct values per parameter, so an order mix-up shows
    for i, name in enumerate(sorted(state["sum"])):
        state["sum"][name].fill_(i + 1.0)
    written = opt.state_to_checkpoint(state)
    jleaves = jax.tree_util.tree_leaves(jstate)
    leaves = tree_leaves(written)
    assert [np.shape(x) for x in leaves] == [x.shape for x in jleaves]
    # kge_tpu's _load: unflatten the port's leaves into its own structure
    loaded = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jstate), leaves)
    labels = jax.tree_util.tree_leaves(JaxKgeOptimizer(jconfig, tree)._labels)
    paths = ["entity_embedder.weights", "relation_embedder.weights"]
    for group, inner in loaded.inner_states.items():
        sums = inner.inner_state[-1]["sum"]
        for path, label in zip(paths, labels):
            part, leaf = path.split(".")
            if label == group:
                np.testing.assert_array_equal(
                    np.asarray(sums[part][leaf]), state["sum"][path].numpy())
    # and back: the port reads kge_tpu's state (optax tuples and all)
    fresh = opt.init()
    opt.load_state(fresh, loaded)
    for name in state["sum"]:
        np.testing.assert_array_equal(fresh["sum"][name].numpy(),
                                      state["sum"][name].numpy())


def test_unported_optimizer_raises():
    """Every optimizer type of kge_tpu is ported (tests/
    test_torch_optimizers.py); an unknown type raises kge_tpu's error."""
    jconfig, pconfig, tree, model = models(
        {"train.optimizer.default.type": "Lion"})
    with pytest.raises(ValueError, match="unsupported optimizer type Lion"):
        JaxKgeOptimizer(jconfig, tree)
    with pytest.raises(ValueError, match="unsupported optimizer type Lion"):
        KgeOptimizer(pconfig, dict(model.named_parameters()))


# ------------------------------------------------------------------ scheduler

SCHEDULERS = [
    ("", {}),
    ("StepLR", {"step_size": 2, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [1, 3], "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("CosineAnnealingLR", {"T_max": 4, "eta_min": 0.1}),
    ("ConstantLR", {"factor": 0.25, "total_iters": 3}),
    ("ReduceLROnPlateau", {"patience": 1, "factor": 0.5}),
]


@pytest.mark.parametrize("name,args", SCHEDULERS,
                         ids=[n or "none" for n, _ in SCHEDULERS])
def test_lr_scale_sequences_match_kge_tpu(name, args):
    options = {"train.lr_scheduler": name, "train.lr_warmup": 2,
               "valid.metric_max": True}
    for key, value in args.items():
        options[f"train.lr_scheduler_args.{key}"] = value
    jconfig, pconfig = configs(options)
    metrics = [0.1, 0.2, 0.2, 0.19, 0.18, 0.3, None, 0.25, 0.2, 0.1]
    sequences = []
    for cls, config in ((JaxKgeLRScheduler, jconfig),
                        (KgeLRScheduler, pconfig)):
        scheduler = cls(config)
        seq = []
        for epoch, metric in enumerate(metrics, start=1):
            seq.append(scheduler.lr_scale(epoch))
            scheduler.step(metric)
        seq.append(scheduler.state_dict())
        sequences.append(seq)
    assert sequences[0] == sequences[1]


# ------------------------------------------------------------------ loss


def test_kl_loss_matches_kge_tpu():
    jconfig, pconfig = configs({"train.loss": "kl"})
    jloss, loss = JaxKgeLoss.create(jconfig), KgeLoss.create(pconfig)
    rng = np.random.default_rng(2)
    scores = (3 * rng.standard_normal((9, 6))).astype(np.float32)
    weights = (rng.random(9) > 0.3).astype(np.float32)
    index_labels = rng.integers(0, 6, 9)
    matrix_labels = (rng.random((9, 6)) > 0.6).astype(np.float32)
    matrix_labels[0] = 0.0  # a row with no positive
    for labels in (index_labels, matrix_labels):
        want = float(jloss(jnp.asarray(scores), jnp.asarray(labels),
                           row_weights=jnp.asarray(weights)))
        got = float(loss(torch.tensor(scores), torch.tensor(labels),
                         row_weights=torch.tensor(weights)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_loss_raises():
    """Every loss of kge_tpu is ported (tests/test_torch_losses.py);
    margin ranking outside negative sampling raises kge_tpu's error."""
    jconfig, pconfig = configs({"train.loss": "margin_ranking",
                                "train.type": "KvsAll"})
    scores = np.zeros((2, 3), dtype=np.float32)
    labels = np.zeros(2, dtype=np.int64)
    for loss, tensor in ((JaxKgeLoss.create(jconfig), jnp.asarray),
                         (KgeLoss.create(pconfig), torch.tensor)):
        with pytest.raises(NotImplementedError,
                           match="only supported with negative sampling"):
            loss(tensor(scores), tensor(labels))
