"""K1, the fused shared-negative loss (kge_tpu_torch/ops/negsamp_loss.py),
against kge_tpu's: on CPU tensors the port's ``shared_ce_loss`` (its
plain version forward, its plain-torch backward) matches
``shared_ce_loss`` in interpret mode and ``shared_ce_loss_xla`` in loss
and lse (rtol 1e-5) and in the gradients of q, cand and pos (rtol 1e-4,
atol 1e-6, as tests/test_pallas.py holds kge_tpu's kernel); the special
rows keep kge_tpu's semantics; the device count expansion equals
``BatchNegativeSample.counts()``; the wrapper refuses what the kernel
does not take. The kernel itself runs only on a card (the ``cuda`` test
here, and ``chip_smoke.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.ops.pallas.negsamp_loss import (
    _forward as jax_forward, shared_ce_loss as jax_shared_ce_loss,
    shared_ce_loss_xla,
)
from kge_tpu.train.sampler import KgeSampler as JaxKgeSampler
from kge_tpu_torch.ops import negsamp_loss as nl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)


def make_inputs(B, N, D, seed):
    """Scores of unit variance at every D (q and cand entries of standard
    deviation D^-1/4)."""
    rng = np.random.default_rng(seed)
    scale = D ** -0.25
    q = (scale * rng.standard_normal((B, D))).astype(np.float32)
    cand = (scale * rng.standard_normal((N, D))).astype(np.float32)
    pos = rng.standard_normal(B).astype(np.float32)
    counts = rng.integers(0, 3, (B, N)).astype(np.float32)
    w = (rng.random(B) > 0.2).astype(np.float32)
    return [q, cand, pos, counts, w]


def port_side(q, cand, pos, counts, w):
    """(loss, lse, [d_q, d_cand, d_pos]) of the port on CPU tensors."""
    qt, ct, pt = (torch.tensor(x, requires_grad=True) for x in (q, cand, pos))
    counts_t, w_t = torch.tensor(counts), torch.tensor(w)
    loss = nl.shared_ce_loss(qt, ct, pt, counts_t, w_t)
    loss.backward()
    with torch.no_grad():
        _, lse = nl.shared_ce_loss_reference(qt, ct, pt, counts_t, w_t)
    return (loss.item(), lse.numpy(),
            [qt.grad.numpy(), ct.grad.numpy(), pt.grad.numpy()])


def jax_side(q, cand, pos, counts, w):
    """(loss interpret, loss xla, lse, grads via the custom VJP, grads
    via autodiff of the XLA form)."""
    args = [jnp.asarray(x) for x in (q, cand, pos, counts, w)]
    loss = jax_shared_ce_loss(*args, True)
    loss_xla = shared_ce_loss_xla(*args)
    _, lse = jax_forward(*args, interpret=True)
    counts_j, w_j = args[3], args[4]
    grads = jax.grad(
        lambda a, b, c: jax_shared_ce_loss(a, b, c, counts_j, w_j, True),
        argnums=(0, 1, 2))(*args[:3])
    grads_xla = jax.grad(
        lambda a, b, c: shared_ce_loss_xla(a, b, c, counts_j, w_j),
        argnums=(0, 1, 2))(*args[:3])
    return (float(loss), float(loss_xla), np.asarray(lse),
            [np.asarray(g) for g in grads], [np.asarray(g) for g in grads_xla])


def assert_matches(inputs, grads=True):
    loss, lse, g = port_side(*inputs)
    j_loss, j_loss_xla, j_lse, j_g, j_g_xla = jax_side(*inputs)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(loss, j_loss_xla, rtol=1e-5)
    np.testing.assert_allclose(lse, j_lse, rtol=1e-5, equal_nan=True)
    if grads:
        for mine, theirs, theirs_xla, name in zip(g, j_g, j_g_xla,
                                                  ("q", "cand", "pos")):
            np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(mine, theirs_xla, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    return loss, lse, g


@pytest.mark.parametrize("B,N,D", [
    (20, 9, 16),      # tests/test_pallas.py's shape
    (1, 5, 8),        # one row
    (37, 129, 32),    # the training path's N (128 + 1), ragged B
    (66, 13, 128),    # N no multiple of anything, the training D
])
def test_shared_ce_loss_matches_kge_tpu(B, N, D):
    assert_matches(make_inputs(B, N, D, seed=B + N + D))


# the kernel's edges: one candidate to 520 (past one staged block: its
# chunked ring), one row to a ragged last block of 8 rows, and D = 37 (its
# 4-byte copies)
@pytest.mark.parametrize("N", [1, 8, 129, 520])
@pytest.mark.parametrize("B", [1, 129, 1000])
def test_shared_ce_loss_edges_match_kge_tpu(B, N):
    assert_matches(shifted(make_inputs(B, N, 16, seed=B * N)))


def test_shared_ce_loss_odd_depth_matches_kge_tpu():
    assert_matches(shifted(make_inputs(129, 129, 37, seed=37)))


def shifted(inputs, by=4.0):
    """The inputs with pos moved up by ``by``: with hundreds of rows and
    few candidates some lse would lie within 1e-2 of 0, where a relative
    tolerance alone cannot hold float32 rounding; lse >= pos keeps them
    away from it."""
    q, cand, pos, counts, w = inputs
    return [q, cand, (pos + by).astype(np.float32), counts, w]


def test_extreme_undrawn_candidate_gives_finite_loss_and_gradients():
    """tests/test_pallas.py:149: an undrawn candidate scoring far above
    lse (q . cand[0] = 1600) must not turn into 0 * inf."""
    B, N, D = 4, 6, 8
    q = np.full((B, D), 10.0, np.float32)
    cand = np.ones((N, D), np.float32)
    cand[0] = 20.0
    pos = np.zeros(B, np.float32)
    counts = np.zeros((B, N), np.float32)
    counts[:, 1:] = 1.0
    w = np.ones(B, np.float32)
    loss, lse, grads = assert_matches([q, cand, pos, counts, w])
    assert np.isfinite(loss) and np.isfinite(lse).all()
    for g in grads:
        assert np.isfinite(g).all()


def test_special_rows_keep_kge_tpu_semantics():
    """An all-zero-counts row has lse == pos and adds 0; w == 0 rows add
    nothing; pos = -inf with drawn candidates gives a finite lse; a NaN
    score with counts > 0 gives a NaN lse (max propagates NaN)."""
    B, N, D = 12, 7, 16
    q, cand, pos, counts, w = make_inputs(B, N, D, seed=5)
    counts[0] = 0.0
    w[1] = w[2] = 0.0
    pos[3] = -np.inf
    inputs = [q, cand, pos, counts, w]
    loss, lse, _ = assert_matches(inputs)
    assert lse[0] == pos[0]
    assert np.isfinite(lse[3])
    assert loss == np.inf  # w[3] = 1 and lse - (-inf) = inf

    pos[3] = 0.0
    q[4, 0] = np.nan  # every score of row 4 is NaN
    counts[4] = 1.0
    _, lse, _ = assert_matches(inputs, grads=False)
    assert np.isnan(lse[4]) and np.isfinite(np.delete(lse, 4)).all()


def _jax_sample(shared_type, with_replacement, batch_size=32, seed=11):
    config = JaxConfig()
    config.folder = None
    for key, value in {
        "dataset.name": "toy", "console.quiet": True,
        "negative_sampling.shared": True,
        "negative_sampling.shared_type": shared_type,
        "negative_sampling.with_replacement": with_replacement,
        "negative_sampling.num_samples.s": 9,
    }.items():
        config.set(key, value)
    dataset = JaxDataset.create(config, os.path.join(REPO, "data", "toy"))
    sampler = JaxKgeSampler.create(config, "negative_sampling", dataset)
    sampler.seed(seed)
    triples = dataset.split("train")[:batch_size]
    return [sampler.sample(triples, slot) for slot in (0, 2, 0)]


@pytest.mark.parametrize("shared_type", ["default", "naive"])
@pytest.mark.parametrize("with_replacement", [True, False])
def test_device_count_expansion_equals_sampler_counts(shared_type,
                                                      with_replacement):
    for ns in _jax_sample(shared_type, with_replacement):
        base, drop = ns.count_factors()
        counts = nl.expand_counts(
            torch.tensor(base), int(ns.num_unique),
            None if drop is None else torch.tensor(drop, dtype=torch.int64),
            ns.counts().shape[0],
        )
        np.testing.assert_array_equal(counts.numpy(), ns.counts())
        assert counts.is_contiguous()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, cand, pos, counts, w = (torch.tensor(x)
                               for x in make_inputs(8, 5, 4, seed=1))
    with pytest.raises(TypeError, match="float32"):
        nl.shared_ce_loss(q.double(), cand, pos, counts, w)
    with pytest.raises(ValueError, match="counts \\[8, 5\\] expected"):
        nl.shared_ce_loss(q, cand, pos, counts[:, :4].contiguous(), w)
    with pytest.raises(ValueError, match="q \\[B, D\\]"):
        nl.shared_ce_loss(q, cand[:, :3].contiguous(), pos, counts, w)
    with pytest.raises(ValueError, match="contiguous"):
        nl.shared_ce_loss(q.T.contiguous().T, cand, pos, counts, w)
    with pytest.raises(TypeError, match="tensor"):
        nl.shared_ce_loss(q, cand, pos.numpy(), counts, w)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, N, D in [(1024, 129, 128), (1000, 37, 128), (1, 5, 8)]:
        inputs = [torch.tensor(x, device="cuda")
                  for x in make_inputs(B, N, D, seed=3)]
        before = nl.shared_ce_loss.launches
        loss, lse = nl.shared_ce_forward(*inputs)
        assert nl.shared_ce_loss.launches == before + 1
        ref_loss, ref_lse = nl.shared_ce_loss_reference(*inputs)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 8, 129, 520])
@pytest.mark.parametrize("B", [1, 129, 1000])
@pytest.mark.parametrize("D", [128, 37])
def test_kernel_edges_match_plain_version_on_the_card(B, N, D):
    """The kernel at its edges on the card, one launch a call, the loss
    bit-identical from call to call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = [torch.tensor(x, device="cuda")
              for x in make_inputs(B, N, D, seed=B + N + D)]
    before = nl.shared_ce_loss.launches
    loss, lse = nl.shared_ce_forward(*inputs)
    assert nl.shared_ce_loss.launches == before + 1
    ref_loss, ref_lse = nl.shared_ce_loss_reference(*inputs)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    assert float(nl.shared_ce_forward(*inputs)[0]) == float(loss)
