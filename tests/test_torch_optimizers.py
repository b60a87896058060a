"""Every optimizer type of the port (kge_tpu_torch/train/optimizer.py)
against kge_tpu's ``KgeOptimizer.apply_updates`` on the same gradients,
made with numpy from a seed: Adagrad, Adam, AdamW, Adamax, RMSprop,
Adadelta and SGD (plain, with momentum, with Nesterov momentum), each
with one parameter group, two groups, and a weight decay, for 5 steps
under a changing learning rate.

Tolerances: the parameters and the state within rtol 1e-6 (atol 1e-7).
The checkpointed state has kge_tpu's leaves, in its order, shapes and
dtypes (the Adam family's step count is an int32 scalar per group), and
each package reads the other's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu.train.optimizer import KgeOptimizer as JaxKgeOptimizer
from kge_tpu_torch.train.optimizer import KgeOptimizer
from kge_tpu_torch.utils.params import tree_leaves
from tests.test_torch_sampler_optimizer import RELATION_GROUP, models

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

TYPES = {
    "Adagrad": {"type": "Adagrad", "args.lr": 0.2},
    "Adam": {"type": "Adam", "args.lr": 0.05},
    "AdamW": {"type": "AdamW", "args.lr": 0.05},
    "Adamax": {"type": "Adamax", "args.lr": 0.05,
               "args.betas": [0.8, 0.99]},
    "RMSprop": {"type": "RMSprop", "args.lr": 0.01},
    "Adadelta": {"type": "Adadelta", "args.lr": 1.0},
    "SGD": {"type": "SGD", "args.lr": 0.1},
    "SGD-momentum": {"type": "SGD", "args.lr": 0.1, "args.momentum": 0.9},
    "SGD-nesterov": {"type": "SGD", "args.lr": 0.1, "args.momentum": 0.9,
                     "args.nesterov": True},
}
GROUPS = {
    "one-group": {},
    "two-groups": RELATION_GROUP,
    "weight-decay": {"train.optimizer.default.args.weight_decay": 0.01},
}


def options(type_name, groups):
    out = {f"train.optimizer.default.{k}": v
           for k, v in TYPES[type_name].items()}
    return {**out, **GROUPS[groups]}


def run_both(type_name, groups, steps=5):
    """kge_tpu's and the port's optimizer after ``steps`` updates with the
    same gradients and learning rates, from the same weights."""
    jconfig, pconfig, tree, model = models(options(type_name, groups))
    jopt = JaxKgeOptimizer(jconfig, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = dict(model.named_parameters())
    opt = KgeOptimizer(pconfig, params)
    state = opt.init()
    assert opt.base_lrs == jopt.base_lrs
    rng = np.random.default_rng(8)
    for step in range(steps):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        scale = (1.0, 0.5, 1.5, 0.25, 1.0)[step % 5]
        lrs = {g: base * scale for g, base in opt.base_lrs.items()}
        jparams, jstate = jopt.apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            {g: jnp.asarray(v, jnp.float32) for g, v in lrs.items()})
        for name, p in params.items():
            part, leaf = name.split(".")
            p.grad = torch.tensor(grads[part][leaf])
        opt.step(state, lrs)
    return jopt, jparams, jstate, opt, params, state


@pytest.mark.parametrize("groups", list(GROUPS))
@pytest.mark.parametrize("type_name", list(TYPES))
def test_steps_match_kge_tpu(type_name, groups):
    _, jparams, _, _, params, _ = run_both(type_name, groups)
    for name, p in params.items():
        part, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[part][leaf]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("groups", list(GROUPS))
@pytest.mark.parametrize("type_name", list(TYPES))
def test_state_crosses_over_in_kge_tpu_leaf_order(type_name, groups):
    """After 5 steps the port writes kge_tpu's leaves (values, shapes,
    dtypes, order); kge_tpu's state unflattened from them is its own, and
    the port reads kge_tpu's state back into a fresh state."""
    _, _, jstate, opt, _, state = run_both(type_name, groups)
    jleaves = jax.tree_util.tree_leaves(jstate)
    leaves = tree_leaves(opt.state_to_checkpoint(state))
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        got, want = np.asarray(got), np.asarray(want)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if type_name.startswith("Adam"):
        # one step count per group, 5 after 5 steps
        counts = [x for x in leaves if np.ndim(x) == 0]
        assert [int(c) for c in counts] == [5] * len(opt.group_names)
    # the port reads kge_tpu's state (optax's named tuples and all)
    fresh = opt.init()
    opt.load_state(fresh, jstate)
    for got, want in zip(tree_leaves(opt.state_to_checkpoint(fresh)),
                         jleaves):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # and kge_tpu takes the port's leaves in its own structure
    loaded = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jstate), leaves)
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(jstate))


def test_count_goes_on_after_a_resume():
    """A state loaded after 3 steps and stepped twice more equals the
    state of 5 uninterrupted steps, its step counts included."""
    jopt, _, _, opt, params, state = run_both("Adam", "two-groups", steps=3)
    saved = opt.state_to_checkpoint(state)
    resumed = opt.init()
    opt.load_state(resumed, saved)
    assert all(int(c) == 3 for c in resumed["count"].values())
    _, _, _, opt5, params5, state5 = run_both("Adam", "two-groups", steps=5)
    rng = np.random.default_rng(8)
    # replay the uninterrupted run's last two gradients on the resumed
    # state (run_both draws them in this order)
    grads = [{name: rng.standard_normal(tuple(p.shape)).astype(np.float32)
              for name, p in params.items()} for _ in range(5)]
    for step in (3, 4):
        lrs = {g: base * (1.0, 0.5, 1.5, 0.25, 1.0)[step]
               for g, base in opt.base_lrs.items()}
        for name, p in params.items():
            p.grad = torch.tensor(grads[step][name])
        opt.step(resumed, lrs)
    for got, want in zip(tree_leaves(opt.state_to_checkpoint(resumed)),
                         tree_leaves(opt5.state_to_checkpoint(state5))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for name in params:
        np.testing.assert_array_equal(params[name].detach().numpy(),
                                      params5[name].detach().numpy())
