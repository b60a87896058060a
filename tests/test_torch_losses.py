"""The port's losses (kge_tpu_torch/train/loss.py) against kge_tpu's on
the same scores, made with numpy from a seed: every loss, with index
and with matrix labels, row weights that mask rows, and its argument
(bce's offset, the self-adversarial temperature, the margin). Some
scores are exactly 0, and some margin-ranking pairs sit exactly at the
margin, where ``max(x, 0)`` gives half its gradient to each side.

Tolerances: the value rtol 1e-6; the gradient against ``jax.grad``
rtol 1e-5, atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig
from kge_tpu.train.loss import KgeLoss as JaxKgeLoss
from kge_tpu_torch import Config
from kge_tpu_torch.train.loss import KgeLoss

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

CASES = {
    "kl": {},
    "ce": {},
    "bce": {},
    "bce-offset": {"train.loss_arg": 0.5},
    "bce_mean": {},
    "bce_mean-offset": {"train.loss_arg": -1.0},
    "bce_self_adversarial": {},
    "bce_self_adversarial-temperature": {
        "user.bce_self_adversarial_temperature": 0.5,
        "train.loss_arg": 0.25},
    "margin_ranking": {},
    "margin_ranking-margin": {"train.loss_arg": 2.0},
    "soft_margin": {},
    "se": {},
}


def losses(name, options):
    """(kge_tpu's loss, the port's loss, the two configs)."""
    out = []
    for cls, create in ((JaxConfig, JaxKgeLoss.create),
                        (Config, KgeLoss.create)):
        config = cls()
        config.folder = None
        config.set("console.quiet", True)
        config.set("train.type", "negative_sampling")
        config.set("train.loss", name.split("-")[0])
        for key, value in options.items():
            config.set(key, value, create=True)
        out.append((create(config), config))
    (jloss, jconfig), (ploss, pconfig) = out
    return jloss, ploss, jconfig, pconfig


def inputs(labels_kind, margin):
    """Scores [9, 6] with exact zeros and exact margin ties, row weights
    with zeros, and index or {0,1} matrix labels."""
    rng = np.random.default_rng(5)
    scores = (2 * rng.standard_normal((9, 6))).astype(np.float32)
    scores[1, 2] = scores[4, 0] = scores[6, 5] = 0.0
    index = rng.integers(0, 6, 9)
    # row 3: a negative exactly at the margin below the positive
    scores[3, (index[3] + 1) % 6] = scores[3, index[3]] - np.float32(margin)
    weights = (rng.random(9) > 0.3).astype(np.float32)
    weights[3] = 1.0
    if labels_kind == "index":
        return scores, index, weights
    matrix = np.zeros((9, 6), dtype=np.float32)
    matrix[np.arange(9), index] = 1.0
    matrix[rng.random((9, 6)) > 0.8] = 1.0
    return scores, matrix, weights


@pytest.mark.parametrize("labels_kind", ["index", "matrix"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_match_kge_tpu(name, labels_kind):
    jloss, ploss, jconfig, pconfig = losses(name, CASES[name])
    # NaN loss_arg becomes the default in both, written back to the config
    np.testing.assert_equal(pconfig.get("train.loss_arg"),
                            jconfig.get("train.loss_arg"))
    margin = (pconfig.get("train.loss_arg")
              if name.startswith("margin") else 1.0)
    scores, labels, weights = inputs(labels_kind, margin)

    def jax_loss(s):
        return jloss(s, jnp.asarray(labels), row_weights=jnp.asarray(weights),
                     num_negatives=5)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(scores))
    got_scores = torch.tensor(scores, requires_grad=True)
    got = ploss(got_scores, torch.tensor(labels),
                row_weights=torch.tensor(weights), num_negatives=5)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_scores.grad.numpy(),
                               np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    if name.startswith("margin") and labels_kind == "index":
        # the pair at the margin: half a unit of gradient, as in JAX
        tie = (int(labels[3]) + 1) % 6
        assert float(got_scores.grad[3, tie]) == 0.5


def test_margin_ranking_only_in_negative_sampling():
    """kge_tpu's margin ranking raises outside negative sampling, when it
    is called; the port's does too."""
    scores, labels, weights = inputs("index", 1.0)
    for config_cls, create, tensor in (
            (JaxConfig, JaxKgeLoss.create, jnp.asarray),
            (Config, KgeLoss.create, torch.tensor)):
        config = config_cls()
        config.folder = None
        config.set("console.quiet", True)
        config.set("train.type", "KvsAll")
        config.set("train.loss", "margin_ranking")
        loss = create(config)
        with pytest.raises(NotImplementedError,
                           match="only supported with negative sampling"):
            loss(tensor(scores), tensor(labels), row_weights=tensor(weights))
