"""Segment sums and the GNN math helpers (counterpart of
``kge_tpu/ops/segment.py``; reference: kge/model/embedder/rgnn_utils.py).

``segment_sum`` is ``index_add_`` into zeros, the counterpart of
``jax.ops.segment_sum`` (both differentiate natively). Circular
correlation uses ``torch.fft``; the initializers draw from an explicit
``torch.Generator`` on its device.
"""

from __future__ import annotations

import math

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[i] = sum of data[j] where segment_ids[j] == i`` over the
    first axis, ``num_segments`` rows."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def degree_norm(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """Symmetric degree edge norm 1/(sqrt(D_src) sqrt(D_dst)), with the
    edge dropout mask folded into the degrees (reference: rgnn_encoder.py
    edge_norm)."""
    deg = segment_sum(mask, src, num_nodes)
    deg_inv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)),
                          0.0)
    return deg_inv[src] * deg_inv[dst] * mask


def ccorr(h_j: torch.Tensor, h_r: torch.Tensor) -> torch.Tensor:
    """Circular correlation conj(F(h_j)) * F(h_r) -> iF, with the
    reference's quirk: its port of the deprecated ``torch.irfft`` cuts the
    rfft spectrum to ``len // 2 + 1`` bins AGAIN before inverting
    (rgnn_utils.py:219-221), zeroing the upper half of the spectrum.
    Trained reference models embed this, and ``kge_tpu`` reproduces it."""
    n = h_j.shape[-1]
    spec = torch.conj(torch.fft.rfft(h_j, dim=-1)) * torch.fft.rfft(h_r,
                                                                   dim=-1)
    keep = spec.shape[-1] // 2 + 1
    spec = torch.nn.functional.pad(spec[..., :keep],
                                   (0, spec.shape[-1] - keep))
    return torch.fft.irfft(spec, n=n, dim=-1)


def ccorr_true(h_j: torch.Tensor, h_r: torch.Tensor) -> torch.Tensor:
    """Textbook circular correlation (the full spectrum)."""
    n = h_j.shape[-1]
    spec = torch.conj(torch.fft.rfft(h_j, dim=-1)) * torch.fft.rfft(h_r,
                                                                   dim=-1)
    return torch.fft.irfft(spec, n=n, dim=-1)


# ---- compositions (reference: rgnn_utils.py:168-224) --------------------

def composition_fn(name: str):
    """``f(h_i, h_j, h_r, w)`` of the named composition; ``w`` is the
    message weight of the ``_weighted`` forms."""
    if name in ("neighbor", "neighbour"):
        return lambda h_i, h_j, h_r, w=None: h_j if w is None else h_j * w
    if name == "sub":
        return lambda h_i, h_j, h_r, w=None: h_j - h_r
    if name == "sub_weighted":
        return lambda h_i, h_j, h_r, w: h_j * w - h_r
    if name == "mult":
        return lambda h_i, h_j, h_r, w=None: h_j * h_r
    if name == "mult_weighted":
        return lambda h_i, h_j, h_r, w: h_j * h_r * w
    if name == "cross":
        return lambda h_i, h_j, h_r, w=None: h_j * h_r + h_j
    if name == "cross_weighted":
        return lambda h_i, h_j, h_r, w: h_j * h_r * w + h_j * w
    if name == "ccorr":
        return lambda h_i, h_j, h_r, w=None: ccorr(h_j, h_r)
    if name == "ccorr_weighted":
        return lambda h_i, h_j, h_r, w: ccorr(h_j * w, h_r)
    if name == "ccorr_true":
        return lambda h_i, h_j, h_r, w=None: ccorr_true(h_j, h_r)
    if name == "ccorr_true_weighted":
        return lambda h_i, h_j, h_r, w: ccorr_true(h_j * w, h_r)
    raise NotImplementedError(f"composition function {name} not found")


# ---- initializers (reference: rgnn_utils.py:130-164) ---------------------

def schlichtkrull_std(shape, gain=1.0, fans=None) -> float:
    if fans is not None:
        fan_in, fan_out = fans
    else:
        fan_in, fan_out = shape[-2], shape[-1]
    return gain * 3.0 / math.sqrt(float(fan_in + fan_out))


def _uniform(generator: torch.Generator, shape, bound: float):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return -bound + 2.0 * bound * u


def schlichtkrull_normal_(generator: torch.Generator, shape, fans=None):
    return schlichtkrull_std(shape, fans=fans) * torch.randn(
        shape, generator=generator, dtype=torch.float32,
        device=generator.device)


def schlichtkrull_uniform_(generator: torch.Generator, shape, fans=None):
    return _uniform(generator, shape, schlichtkrull_std(shape, fans=fans))


def wgcn_uniform_(generator: torch.Generator, shape):
    std = 1.0 / math.sqrt(shape[0] if len(shape) == 1 else shape[1])
    return _uniform(generator, shape, std)
