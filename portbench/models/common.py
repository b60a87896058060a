"""What the plain references share: float32 products with TF32 off, or
with their operands rounded to TF32 (the control), and the optimizer.

Plain torch and numpy only: nothing of the program is imported here or
in any module of this folder (``tests/test_portbench_reference.py``
checks the imports)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    with ties to even, as a tensor core reads a float32 operand when
    TF32 is on."""
    bits = x.detach().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return ((bits + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(
        torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` on TF32-rounded operands with float32 accumulation, and
    its two gradient products the same way, as cuBLAS computes all three
    with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def _rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 in the forward pass, the identity in the
    backward (a convolution's operands)."""
    return x + (round_tf32(x.detach()) - x).detach()


class Products:
    """Matrix products and convolutions in float32 (TF32 switched off on a
    card), or, as the control, on operands rounded to TF32 with float32
    accumulation: the precision a later change might be tempted to take."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _TF32Product.apply(a, b) if self.tf32 else a @ b

    def conv2d(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            x, w = _rounded(x), _rounded(w)
        return F.conv2d(x, w)


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, Dict[str, torch.Tensor]], step: int, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step (Kingma and Ba, Algorithm 1) of every leaf in place;
    a leaf without a gradient takes a zero one."""
    for name, p in params.items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        mu = state.setdefault("mu", {}).setdefault(name, torch.zeros_like(p))
        nu = state.setdefault("nu", {}).setdefault(name, torch.zeros_like(p))
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        mu_hat = mu / (1 - b1 ** step)
        nu_hat = nu / (1 - b2 ** step)
        p.sub_(lr * mu_hat / (nu_hat.sqrt() + eps))

