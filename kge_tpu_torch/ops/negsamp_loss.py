"""Fused shared-negative cross-entropy loss (counterpart of
``kge_tpu/ops/pallas/negsamp_loss.py``).

With shared negative sampling every row of a batch scores the same
unique candidates; which of them (and how often) a row drew is its row of
``counts`` (the count form of the reference's per-row gather,
kge/job/train_negative_sampling.py:177-186). Per row,

    lse_b = log(exp(pos_b) + sum_n counts[b, n] * exp(q_b . cand_n))
    loss  = sum_b w_b * (lse_b - pos_b)

``shared_ce_loss`` is a ``torch.autograd.Function``: on a CUDA tensor its
forward launches the hand-written kernel ``csrc/negsamp_loss.cu`` (and
counts the launch in ``shared_ce_loss.launches``); on a CPU tensor it
takes the plain version ``shared_ce_loss_reference``. The backward is
plain torch in both cases, as ``kge_tpu``'s custom VJP is plain XLA.

Under ``tpu.compute_dtype: bfloat16`` q, cand and pos arrive in bf16:
the autograd function casts its operands to float32 before the kernel
(as ``kge_tpu``'s ``_forward`` does before its ``pallas_call``), and its
backward computes in float32 and returns each gradient in its operand's
dtype (``_bwd``).

A CUDA graph can capture the wrapper and its backward: the output comes
from the current allocator (the graph's pool under capture), the launch
and the C entry's memset of the last-block ticket go to the current
stream (the capture stream), so a replay zeroes the ticket before the
kernel as a call does; the kernel's shared-memory attribute is set at
its first call on a device, which the trainer's warm-up makes before it
captures. ``launches`` counts calls, and a replay makes none: the
trainer adds a graph's captured launches to it on every replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from kge_tpu_torch.ops import native


def expand_counts(base: torch.Tensor, nu: Union[int, torch.Tensor],
                  drop: Optional[torch.Tensor], rows: int) -> torch.Tensor:
    """[rows, num+1] candidate multiplicities from the shared sample's
    factors: the base multiplicities [num+1], the number of unique
    candidates ``nu`` (an int, or a 0-d tensor on ``base``'s device, as
    on-device sampling draws it) and, for ``default`` sharing, each row's
    dropped position [rows] (its mass moves to the extra candidate at
    ``nu``). Vector ops on the device, no scatter and no host sync, so a
    CUDA graph can capture it. KEEP IN LOCKSTEP with
    ``kge_tpu_torch.train.sampler.BatchNegativeSample.counts`` (numpy)
    and ``kge_tpu``'s ``_fused_loss``."""
    num1 = base.shape[-1]
    if drop is None:  # naive sharing: every row sees the same multiset
        return base.expand(rows, num1).contiguous()
    cols = torch.arange(num1, device=base.device)
    extra = torch.where(drop < nu, base[drop.clamp(0, num1 - 1)], 0.0)
    counts = base[None, :] * (cols[None, :] != drop[:, None])
    return torch.where(cols[None, :] == nu, extra[:, None], counts)


def shared_ce_loss_reference(q: torch.Tensor, cand: torch.Tensor,
                             pos: torch.Tensor, counts: torch.Tensor,
                             w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, line for line ``kge_tpu``'s
    ``shared_ce_loss_xla``; returns (loss, lse). Undrawn columns (counts
    0) are kept out of the row max. On a CUDA device the matmul follows
    ``torch.backends.cuda.matmul.allow_tf32``, which training keeps
    False."""
    scores = q @ cand.T
    s_masked = torch.where(counts > 0, scores, -torch.inf)
    if cand.shape[0]:
        m = torch.maximum(torch.amax(s_masked, dim=1), pos)
    else:
        m = pos
    z = torch.exp(pos - m) + torch.sum(
        counts * torch.exp(s_masked - m[:, None]), dim=1
    )
    lse = m + torch.log(z)
    return torch.sum(w * (lse - pos)), lse


@functools.lru_cache(maxsize=None)
def _library():
    lib = native.load("negsamp_loss")
    lib.kge_shared_ce_loss.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.kge_shared_ce_loss.restype = ctypes.c_int
    lib.kge_shared_ce_loss_out_size.argtypes = [ctypes.c_int]
    lib.kge_shared_ce_loss_out_size.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _out_size(B: int) -> int:
    """Floats of the kernel's output for B rows: lse, the loss, a ticket
    counter and one partial per block."""
    return _library().kge_shared_ce_loss_out_size(B)


def _check(q, cand, pos, counts, w) -> Tuple[int, int, int, torch.device]:
    """Refuses what the kernel does not take; returns (B, N, D, device)."""
    device = None
    for name, x in (("q", q), ("cand", cand), ("pos", pos),
                    ("counts", counts), ("w", w)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"shared_ce_loss: {name} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(
                f"shared_ce_loss: {name} must be float32, got {x.dtype}"
            )
        x_device = x.device
        device = device or x_device
        if x_device != device:
            raise ValueError(
                f"shared_ce_loss: {name} is on {x_device}, q on {device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"shared_ce_loss: {name} must be contiguous")
    q_shape, cand_shape = tuple(q.shape), tuple(cand.shape)
    if len(q_shape) != 2 or len(cand_shape) != 2 or q_shape[1] != cand_shape[1]:
        raise ValueError(
            f"shared_ce_loss: q [B, D] and cand [N, D] expected, got "
            f"{q_shape} and {cand_shape}"
        )
    (B, D), N = q_shape, cand_shape[0]
    pos_shape, w_shape = tuple(pos.shape), tuple(w.shape)
    counts_shape = tuple(counts.shape)
    if pos_shape != (B,) or w_shape != (B,) or counts_shape != (B, N):
        raise ValueError(
            f"shared_ce_loss: pos [{B}], w [{B}] and counts [{B}, {N}] "
            f"expected, got {pos_shape}, {w_shape} and {counts_shape}"
        )
    if max(B, N, D) >= 2 ** 31:
        raise ValueError("shared_ce_loss: sizes must be below 2^31")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"shared_ce_loss: unsupported device {device}")
    return B, N, D, device


def shared_ce_forward(q: torch.Tensor, cand: torch.Tensor,
                      pos: torch.Tensor, counts: torch.Tensor,
                      w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse) without gradients: the kernel on a CUDA device, the
    plain version on the CPU. Arguments as for ``shared_ce_loss``. On the
    card lse and the loss are views of the kernel's one output buffer."""
    B, N, D, device = _check(q, cand, pos, counts, w)
    if device.type == "cpu":
        return shared_ce_loss_reference(q, cand, pos, counts, w)
    if B == 0:
        return q.new_zeros(()), q.new_empty((0,))
    out = torch.empty(_out_size(B), dtype=torch.float32, device=device)
    # the raw stream handle, as the row-update wrapper takes it: no
    # torch.cuda.Stream object a call
    args = (q.data_ptr(), cand.data_ptr(), pos.data_ptr(), counts.data_ptr(),
            w.data_ptr(), out.data_ptr(), B, N, D,
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = _library().kge_shared_ce_loss(*args)
    else:
        with torch.cuda.device(device):
            err = _library().kge_shared_ce_loss(*args)
    if err != 0:
        raise RuntimeError(
            f"negsamp_loss kernel launch failed with CUDA error {err}"
        )
    shared_ce_loss.launches += 1
    return out[B], out[:B]


class _SharedCELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, cand, pos, counts, w):
        ctx.dtypes = q.dtype, cand.dtype, pos.dtype
        q, cand, pos, w = (x.float() if x.dtype == torch.bfloat16 else x
                           for x in (q, cand, pos, w))
        loss, lse = shared_ce_forward(q, cand, pos, counts, w)
        ctx.save_for_backward(q, cand, pos, counts, w, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        """``kge_tpu``'s ``_bwd``: recompute the scores; undrawn columns
        are masked before the exponential is weighted, so one scoring far
        above lse gives no 0 * inf."""
        q, cand, pos, counts, w, lse = ctx.saved_tensors
        scores = q @ cand.T
        p = torch.where(counts > 0, counts * torch.exp(scores - lse[:, None]),
                        0.0)
        gw = g * w
        d_pos = gw * (torch.exp(pos - lse) - 1.0)
        d_scores = gw[:, None] * p
        q_dtype, cand_dtype, pos_dtype = ctx.dtypes
        return ((d_scores @ cand).to(q_dtype), (d_scores.T @ q).to(cand_dtype),
                d_pos.to(pos_dtype), None, None)


def shared_ce_loss(q: torch.Tensor, cand: torch.Tensor, pos: torch.Tensor,
                   counts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_b w[b] * (logsumexp({pos[b]} u multiset of row b's candidate
    scores) - pos[b]), differentiable in q, cand and pos.

    q [B, D] query vectors, cand [N, D] unique candidate vectors, pos [B]
    positive scores, counts [B, N] multiplicity of each candidate in row
    b's sample, w [B] row weights: contiguous, on one device; counts
    float32, the others float32 or bf16 (bf16 is cast to float32 for
    the kernel; other dtypes are refused)."""
    return _SharedCELoss.apply(q, cand, pos, counts, w)


shared_ce_loss.launches = 0
