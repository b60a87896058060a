"""The port's rank_counts (kge_tpu_torch/ops/rank_count.py) against
kge_tpu's Pallas kernel, run in interpret mode, and its XLA referee, on
the same seeded inputs. Rank and tie counts must be exactly equal.

On the CPU the port's wrapper takes its plain version; the CUDA kernel
itself is held against that plain version by the ``cuda`` test below
(skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kge_tpu.ops.pallas.rank_count import (
    greater_tie_counts as jax_greater_tie_counts,
    rank_counts as jax_rank_counts,
    rank_counts_xla,
)
from kge_tpu_torch.ops.rank_count import (
    greater_tie_counts,
    rank_counts,
    rank_counts_reference,
)


def _inputs(B, C, D, seed):
    """Normal q/cand; duplicate candidate rows; cand_valid holes; true
    scores: half tie with candidate 0 (and its duplicate), half drawn
    from the score distribution."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    cand = rng.standard_normal((C, D)).astype(np.float32)
    n_dup = min(3, C // 2)
    cand[C - n_dup:] = cand[:n_dup]
    valid = (np.arange(C) % 7 != 3).astype(np.float32)
    s0 = q.astype(np.float64) @ cand[0].astype(np.float64)
    spread = np.sqrt(D) * rng.standard_normal(B)
    true = np.where(np.arange(B) % 2 == 0, s0, spread).astype(np.float32)
    return q, cand, true, valid


def _port(q, cand, true, valid, **kw):
    r, t = rank_counts(torch.from_numpy(q), torch.from_numpy(cand),
                       torch.from_numpy(true), torch.from_numpy(valid), **kw)
    assert r.dtype == t.dtype == torch.int32
    return r.numpy(), t.numpy()


def _jax(q, cand, true, valid, **kw):
    args = [jnp.asarray(x) for x in (q, cand, true, valid)]
    r1, t1 = jax_rank_counts(*args, interpret=True, tb=128, tc=512, **kw)
    r2, t2 = rank_counts_xla(*args, **kw)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    return np.asarray(r1), np.asarray(t1)


# C is a multiple of no tile size anywhere (128, 512, 8192)
@pytest.mark.parametrize("B,C,D", [
    (1, 77, 16), (10, 333, 2), (37, 1001, 128), (130, 2999, 16),
])
def test_rank_counts_equal_jax(B, C, D):
    q, cand, true, valid = _inputs(B, C, D, seed=B + C + D)
    r, t = _port(q, cand, true, valid)
    r_ref, t_ref = _jax(q, cand, true, valid)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(t, t_ref)
    # candidate 0 and its duplicate tie with rows whose true score is
    # theirs
    assert (t[::2] >= 2).all()


# the kernel's tile edges: B around its 112- and 128-row tiles, a ragged
# last candidate tile (1001 = 7 * 128 + 105), D = 37 (its 4-byte copies)
# and D = 416 (too deep for a resident q tile: the shape that carries q
# in its ring)
@pytest.mark.parametrize("B,C,D", [
    (1, 1001, 16), (127, 1001, 16), (128, 1001, 16), (129, 1001, 16),
    (256, 1001, 16), (100, 1001, 37), (129, 300, 416),
])
def test_rank_counts_tile_edges_equal_jax(B, C, D):
    q, cand, true, valid = _inputs(B, C, D, seed=B + C + D)
    r, t = _port(q, cand, true, valid)
    r_ref, t_ref = _jax(q, cand, true, valid)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(t, t_ref)


@pytest.mark.parametrize("offset", [0, 1])
def test_rank_counts_leading_row_view_equal_jax(offset):
    """cand as the leading rows of a longer table (the eval reads the
    embedding table in place), at its start and one float past it."""
    q, cand, true, valid = _inputs(37, 1001, 16, seed=7)
    flat = torch.zeros(offset + cand.size + 5 * 16)
    flat[offset:offset + cand.size] = torch.from_numpy(cand).flatten()
    view = flat[offset:offset + cand.size].view(cand.shape)
    assert view.is_contiguous()
    assert view.data_ptr() - flat.data_ptr() == 4 * offset
    r, t = rank_counts(torch.from_numpy(q), view, torch.from_numpy(true),
                       torch.from_numpy(valid))
    r_ref, t_ref = _jax(q, cand, true, valid)
    np.testing.assert_array_equal(r.numpy(), r_ref)
    np.testing.assert_array_equal(t.numpy(), t_ref)


def test_rank_counts_tie_tolerances():
    """The boundary case of tests/test_pallas.py: 1.5 is greater; 1.0 and
    1.0+5e-6 tie; 0.5 is below."""
    q = np.asarray([[1.0]], np.float32)
    cand = np.asarray([[1.0], [1.0 + 5e-6], [1.5], [0.5]], np.float32)
    true = np.asarray([1.0], np.float32)
    valid = np.ones(4, np.float32)
    for kw in ({}, dict(atol=1e-5, rtol=1e-4), dict(atol=0.0, rtol=0.0)):
        r, t = _port(q, cand, true, valid, **kw)
        r_ref, t_ref = _jax(q, cand, true, valid, **kw)
        assert (r[0], t[0]) == (r_ref[0], t_ref[0])
    r, t = _port(q, cand, true, valid)
    assert (int(r[0]), int(t[0])) == (1, 2)


def test_rank_counts_nonfinite_true_and_scores():
    """-inf true ranks last (every finite score greater, none tie);
    +inf true ranks first; a NaN true score counts nothing; NaN scores
    compare as -inf and so tie only with a -inf true score."""
    q = np.asarray([[1.0], [1.0], [1.0]], np.float32)
    cand = np.asarray([[2.0], [-3.0], [0.0], [np.nan]], np.float32)
    valid = np.ones(4, np.float32)
    true = np.asarray([-np.inf, np.inf, np.nan], np.float32)
    r, t = _port(q, cand, true, valid)
    r_ref, t_ref = _jax(q, cand, true, valid)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(t, t_ref)
    assert r.tolist() == [3, 0, 0] and t.tolist() == [1, 0, 0]


def test_greater_tie_counts_equal_jax():
    """NaN true scores rank last; equal infinities tie; valid masks."""
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((4, 3, 9)).astype(np.float32)
    scores[0, 0, :3] = [-np.inf, np.inf, np.nan]
    true = scores[:, :, :1].copy()
    true[1, 1, 0] = np.nan
    true[2, 2, 0] = -np.inf
    valid = rng.random((4, 3, 9)) > 0.2
    r, t = greater_tie_counts(torch.from_numpy(scores),
                              torch.from_numpy(true),
                              torch.from_numpy(valid), dim=2)
    r_ref, t_ref = jax_greater_tie_counts(
        jnp.asarray(scores), jnp.asarray(true), jnp.asarray(valid), axis=2
    )
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))


def test_reference_chunking_is_exact():
    q, cand, true, valid = _inputs(9, 1000, 8, seed=3)
    args = [torch.from_numpy(x) for x in (q, cand, true, valid)]
    whole = rank_counts_reference(*args)
    chunked = rank_counts_reference(*args, chunk_size=64)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    "dtype", "true_shape", "valid_shape", "depth", "contiguity", "device",
])
def test_rank_counts_rejects_unsupported_inputs(case):
    q, cand, true, valid = (torch.from_numpy(x)
                            for x in _inputs(4, 20, 8, seed=1))
    if case == "dtype":
        q = q.double()
    elif case == "true_shape":
        true = true[:3]
    elif case == "valid_shape":
        valid = valid[:, None]
    elif case == "depth":
        cand = cand[:, :4].contiguous()
    elif case == "contiguity":
        cand = cand.T.contiguous().T
    elif case == "device":
        # a tensor that is not on the CPU never takes the plain version
        q, cand, true, valid = (x.to("meta") for x in (q, cand, true, valid))
    with pytest.raises((TypeError, ValueError)):
        rank_counts(q, cand, true, valid)


@pytest.mark.cuda
def test_rank_count_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, cand, true, valid = (torch.from_numpy(x).cuda()
                            for x in _inputs(100, 14541, 128, seed=0))
    before = rank_counts.launches
    r, t = rank_counts(q, cand, true, valid)
    assert rank_counts.launches == before + 1
    r_ref, t_ref = rank_counts_reference(q, cand, true, valid)
    assert torch.equal(r, r_ref) and torch.equal(t, t_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,D,offset", [
    (1, 14541, 128, 0), (127, 14541, 128, 0), (128, 14541, 128, 0),
    (129, 14541, 128, 0), (256, 14541, 128, 0), (100, 14541, 37, 0),
    (300, 14541, 37, 0), (100, 14541, 416, 0), (300, 14541, 416, 0),
    (100, 14541, 128, 1), (300, 14541, 128, 1), (127, 20000, 128, 0),
    (128, 20000, 128, 0), (129, 20000, 128, 0),
])
def test_rank_count_kernel_tile_edges_on_card(B, C, D, offset):
    """The kernel's edges on the card, in both of its shapes. At 14,541
    candidates B <= 129 takes the narrow one (112-row tiles) and 256 and
    300 the wide one; at 20,000 candidates B = 127, 128 and 129 take the
    wide one (128-row tiles). Also a ragged candidate tile, D = 37, D = 416
    (too deep for the wide shape's resident q tile, so the narrow one at
    any B), and (offset 1) cand 4 bytes past a 16-byte boundary, which
    takes the 4-byte copies.
    Counts equal the plain version's on these inputs (no pair at the tie
    boundary)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, cand, true, valid = (torch.from_numpy(x).cuda()
                            for x in _inputs(B, C, D, seed=B + D))
    flat = torch.zeros(offset + C * D, device="cuda")
    flat[offset:] = cand.flatten()
    cand = flat[offset:].view(C, D)
    r, t = rank_counts(q, cand, true, valid)
    r_ref, t_ref = rank_counts_reference(q, cand, true, valid)
    assert torch.equal(r, r_ref) and torch.equal(t, t_ref)
