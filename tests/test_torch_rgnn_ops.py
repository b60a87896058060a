"""The port's GNN math (kge_tpu_torch/ops/segment.py) against
kge_tpu/ops/segment.py on the same seeded inputs: ``segment_sum``,
``degree_norm`` (a dropped edge folded into the degrees, a node of
degree 0), ``ccorr`` with the reference's truncated spectrum,
``ccorr_true`` and every composition, forward and gradients (against
``jax.grad``), at even and odd widths; and the initializers by their
statistics. Tolerances: ``TOL`` for values and gradients (float32 in
both; pocketfft in both on the CPU, in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu.ops import segment as jseg
from kge_tpu_torch.ops import segment as seg

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

COMPOSITIONS = ["neighbor", "neighbour", "sub", "sub_weighted", "mult",
                "mult_weighted", "cross", "cross_weighted", "ccorr",
                "ccorr_weighted", "ccorr_true", "ccorr_true_weighted"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_segment_sum_matches_kge_tpu():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((50, 7)).astype(np.float32)
    ids = rng.integers(0, 12, 50)
    ids[:3] = 14  # rows past the last id stay zero below
    want = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 16)
    got = seg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert not _np(got)[12:14].any()
    # 1-D data (the degrees, the attention denominators)
    got = seg.segment_sum(torch.from_numpy(data[:, 0]),
                          torch.from_numpy(ids), 16)
    want = jseg.segment_sum(jnp.asarray(data[:, 0]), jnp.asarray(ids), 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_degree_norm_matches_kge_tpu():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 9, 40), rng.integers(0, 9, 40)
    src[src == 8] = 7  # node 8 has no outgoing edge: degree 0
    mask = (rng.random(40) < 0.7).astype(np.float32)
    want = jseg.degree_norm(*map(jnp.asarray, (src, dst, mask)), 10)
    got = seg.degree_norm(*map(torch.from_numpy, (src, dst, mask)), 10)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.all(_np(got)[mask == 0] == 0)


@pytest.mark.parametrize("width", [8, 9, 200])
@pytest.mark.parametrize("name", COMPOSITIONS)
def test_composition_and_gradients_match_kge_tpu(name, width):
    """Each composition of (h_j, h_r, w) and its gradient with respect
    to each input (of a random projection of the output)."""
    rng = np.random.default_rng(width)
    shape = (6, width)
    h_j, h_r, w, proj = (rng.standard_normal(shape).astype(np.float32)
                         for _ in range(4))
    weighted = name.endswith("weighted")

    def jax_out(a, b, c):
        f = jseg.composition_fn(name)
        out = f(None, a, b, c) if weighted else f(None, a, b)
        return jnp.sum(out * proj), out

    jgrads, jout = jax.grad(jax_out, argnums=(0, 1, 2),
                            has_aux=True)(h_j, h_r, w)
    args = [torch.tensor(a, requires_grad=True) for a in (h_j, h_r, w)]
    f = seg.composition_fn(name)
    out = f(None, *args) if weighted else f(None, *args[:2])
    torch.sum(out * torch.from_numpy(proj)).backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    for i, (got, want) in enumerate(zip(args, jgrads)):
        grad = got.grad if got.grad is not None else torch.zeros(shape)
        np.testing.assert_allclose(_np(grad), np.asarray(want),
                                   err_msg=f"input {i}", **TOL)


def test_ccorr_keeps_the_reference_quirk():
    """``ccorr`` zeroes the upper half of the spectrum (the reference's
    double truncation); ``ccorr_true`` is the textbook circular
    correlation sum_k a[k] b[(k + i) % n]."""
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((3, 10)) for _ in range(2))
    true = np.stack([[np.sum(a[r] * np.roll(b[r], -i)) for i in range(10)]
                     for r in range(3)])
    got = seg.ccorr_true(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), true, atol=1e-10)
    quirk = _np(seg.ccorr(torch.from_numpy(a), torch.from_numpy(b)))
    assert not np.allclose(quirk, true)
    spec = np.fft.rfft(quirk, axis=-1)
    np.testing.assert_allclose(spec[:, 6 // 2 + 1:], 0, atol=1e-12)


def test_unknown_composition_raises_as_kge_tpu():
    for fn in (seg.composition_fn, jseg.composition_fn):
        with pytest.raises(NotImplementedError,
                           match="composition function rotate not found"):
            fn("rotate")


@pytest.mark.parametrize("name,shape,fans,bound", [
    ("schlichtkrull_normal_", (64, 96), None, None),
    ("schlichtkrull_normal_", (40, 5, 5, 5), [237, 5], None),
    ("schlichtkrull_uniform_", (64, 96), None, None),
    ("wgcn_uniform_", (64, 96), None, 1 / math.sqrt(96)),
    ("wgcn_uniform_", (500,), None, 1 / math.sqrt(500)),
])
def test_initializers_by_their_statistics(name, shape, fans, bound):
    """Means within 5 standard errors of 0; normal draws with kge_tpu's
    std 3 / sqrt(fan_in + fan_out) (within 5%), uniform draws inside
    their bound and filling it."""
    g = torch.Generator().manual_seed(3)
    fn = getattr(seg, name)
    x = (fn(g, shape, fans=fans) if name.startswith("schlichtkrull")
         else fn(g, shape)).numpy()
    assert x.shape == shape and x.dtype == np.float32
    if name.startswith("schlichtkrull"):
        std = jseg.schlichtkrull_std(shape, fans=fans)
        if name.endswith("uniform_"):
            bound = std
    n = x.size
    if bound is None:
        assert abs(x.std() / std - 1) < 0.05
        assert abs(x.mean()) < 5 * std / math.sqrt(n)
    else:
        assert np.abs(x).max() <= bound
        assert np.abs(x).max() > 0.95 * bound
        assert abs(x.mean()) < 5 * bound / math.sqrt(3 * n)
    # the same scheme in kge_tpu, by the same statistics
    key = jax.random.PRNGKey(0)
    j = np.asarray(getattr(jseg, name)(key, shape, fans=fans)
                   if name.startswith("schlichtkrull")
                   else getattr(jseg, name)(key, shape))
    assert abs(j.std() / x.std() - 1) < 0.05
