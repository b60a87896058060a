"""Fused score + rank count for entity-ranking evaluation (counterpart of
``kge_tpu/ops/pallas/rank_count.py``).

Entity ranking needs, per query row, only two numbers: how many
candidate scores are strictly greater than the true score (beyond the tie
tolerance) and how many tie with it (reference semantics:
kge/job/eval_entity_ranking.py:571-596). ``rank_counts`` computes them
for ``scores = q @ cand^T`` without storing the score matrix: on a CUDA
tensor it launches the hand-written kernel ``csrc/rank_count.cu``; on a
CPU tensor it takes the plain version ``rank_counts_reference``.

``_greater_close`` is the one statement of the tie semantics, shared by
the plain version and ``greater_tie_counts``; the kernel states the same
rules in CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from kge_tpu_torch.ops import native


def _greater_close(scores: torch.Tensor, t: torch.Tensor, atol: float,
                   rtol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(greater, close) masks. NaN scores compare as -inf. The tolerance
    term applies to FINITE pairs only; non-finite values are close iff
    equal (torch.isclose semantics)."""
    scores = torch.where(torch.isnan(scores), -torch.inf, scores)
    finite = torch.isfinite(scores) & torch.isfinite(t)
    is_close = (scores == t) | (
        finite & ((scores - t).abs() <= atol + rtol * t.abs())
    )
    return (scores > t) & ~is_close, is_close


def greater_tie_counts(scores: torch.Tensor, true: torch.Tensor,
                       valid: torch.Tensor, dim: int, atol: float = 1e-5,
                       rtol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greater/tie counts (int32) over precomputed scores: NaN scores and
    NaN true scores rank last, ``valid`` masks padding."""
    t = torch.where(torch.isnan(true), -torch.inf, true)
    is_greater, is_close = _greater_close(scores, t, atol, rtol)
    rank = (is_greater & valid).sum(dim=dim, dtype=torch.int32)
    ties = (is_close & valid).sum(dim=dim, dtype=torch.int32)
    return rank, ties


def rank_counts_reference(q: torch.Tensor, cand: torch.Tensor,
                          true: torch.Tensor, cand_valid: torch.Tensor,
                          atol: float = 1e-5, rtol: float = 1e-4,
                          chunk_size: int = 1 << 16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel (and of ``kge_tpu``'s
    ``rank_counts_xla``): a matmul and the tie rules, chunked over the
    candidates so a Wikidata5M-size table fits. ``true`` is used as
    given (a NaN true score counts nothing, as in the kernel). On a CUDA
    device the matmul follows ``torch.backends.cuda.matmul.allow_tf32``,
    which callers comparing with the kernel keep False."""
    B, C = q.shape[0], cand.shape[0]
    rank = torch.zeros(B, dtype=torch.int32, device=q.device)
    ties = torch.zeros(B, dtype=torch.int32, device=q.device)
    for c0 in range(0, C, chunk_size):
        scores = q @ cand[c0:c0 + chunk_size].T
        is_greater, is_close = _greater_close(scores, true[:, None], atol,
                                              rtol)
        valid = cand_valid[None, c0:c0 + chunk_size] > 0
        rank += (is_greater & valid).sum(dim=1, dtype=torch.int32)
        ties += (is_close & valid).sum(dim=1, dtype=torch.int32)
    return rank, ties


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = native.load("rank_count").kge_rank_counts
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, cand, true, cand_valid) -> Tuple[int, int, int, torch.device]:
    """Refuses what the kernel does not take; returns (B, C, D, device)."""
    device = None
    for name, x in (("q", q), ("cand", cand), ("true", true),
                    ("cand_valid", cand_valid)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"rank_counts: {name} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(
                f"rank_counts: {name} must be float32, got {x.dtype}"
            )
        x_device = x.device
        device = device or x_device
        if x_device != device:
            raise ValueError(
                f"rank_counts: {name} is on {x_device}, q on {device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"rank_counts: {name} must be contiguous")
    q_shape, cand_shape = tuple(q.shape), tuple(cand.shape)
    if len(q_shape) != 2 or len(cand_shape) != 2 or q_shape[1] != cand_shape[1]:
        raise ValueError(
            f"rank_counts: q [B, D] and cand [C, D] expected, got "
            f"{q_shape} and {cand_shape}"
        )
    (B, D), C = q_shape, cand_shape[0]
    true_shape, valid_shape = tuple(true.shape), tuple(cand_valid.shape)
    if true_shape != (B,) or valid_shape != (C,):
        raise ValueError(
            f"rank_counts: true [{B}] and cand_valid [{C}] expected, got "
            f"{true_shape} and {valid_shape}"
        )
    if max(B, C, D) >= 2 ** 31:
        raise ValueError("rank_counts: sizes must be below 2^31")
    return B, C, D, device


def rank_counts(q: torch.Tensor, cand: torch.Tensor, true: torch.Tensor,
                cand_valid: torch.Tensor, atol: float = 1e-5,
                rtol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank [B], ties [B]) int32 counts of ``true`` within the scores
    ``q @ cand^T``, over the candidates with ``cand_valid > 0``.

    q [B, D], cand [C, D] (unpadded; may be a leading-row view of a
    padded table), true [B] and cand_valid [C]: float32, contiguous, on
    one device. NaN scores compare as -inf; the caller replaces NaN true
    scores beforehand. CUDA tensors launch the kernel (and count the
    launch in ``rank_counts.launches``); CPU tensors take
    ``rank_counts_reference``. On the card both counts are rows of one
    [2, B] buffer, which the kernel's entry point zeroes on the stream."""
    B, C, D, device = _check(q, cand, true, cand_valid)
    if device.type == "cpu":
        return rank_counts_reference(q, cand, true, cand_valid, atol, rtol)
    if device.type != "cuda":
        raise ValueError(f"rank_counts: unsupported device {device}")
    if B == 0 or C == 0:
        out = torch.zeros((2, B), dtype=torch.int32, device=device)
        return out[0], out[1]
    out = torch.empty((2, B), dtype=torch.int32, device=device)
    args = (q.data_ptr(), cand.data_ptr(), true.data_ptr(),
            cand_valid.data_ptr(), out.data_ptr(), B, C, D, atol, rtol,
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(device):
            err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(
            f"rank_count kernel launch failed with CUDA error {err}"
        )
    rank_counts.launches += 1
    return out[0], out[1]


rank_counts.launches = 0
