"""CompGCN's circular-correlation messages reduced by node in the spectral
domain (no counterpart in ``kge_tpu``, which computes ccorr per edge).

``ccorr(h_j, h_r) = irfft(trunc(conj(F h_j) * F h_r))`` is a product of
spectra bin by bin, and the inverse FFT, the mode weight and the per-edge
scale are linear, so a mode's sum over a node's edges is

    sum_e s_e * ccorr(x[nbr_e], r[type_e]) @ W
        = irfft(sum_e s_e * conj(X[nbr_e]) * R[type_e]) @ W

with ``X = rfft(x)`` and ``R = rfft(r)`` cut to the bins ccorr keeps
(``spectrum_bins``): the FFTs run once on the node and relation tables,
the inverse FFT and the weight once on the node sums, and per edge there
remain a gather of two spectrum rows, a complex product, a scale and a
sum by node. That is ``ccorr_reduce``: on CUDA tensors the hand-written
kernel of ``csrc/ccorr_reduce.cu`` (each launch counts one in
``ccorr_reduce.launches``), on CPU tensors its plain version
``ccorr_reduce_reference``. ``CcorrReduce`` is its autograd function:
the forward reduces by aggregation node, the backward reduces the
output's gradient by neighbour (the node spectra's gradient) and by
relation (the relation spectra's), each with the same kernel.

A spectrum table is float32 ``[rows, Kp, 2]`` (re, im), its ``K`` bins
padded with a zero bin to an even ``Kp``, so a row is whole 16-byte
chunks of two bins. The three orders of an edge set (``build_orders``,
built on the host once per graph) list its edges grouped by the row they
sum into, with the rows they gather, and cut each row's run into pieces
of at most ``PIECE_EDGES`` edges: the kernel sums each piece in one warp,
then each row's pieces in their order, with no atomics, so a call gives
the same bits every time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from kge_tpu_torch import native as hostops
from kge_tpu_torch.ops import native

#: the most edges of one piece (one warp of the kernel's first pass)
PIECE_EDGES = 32
#: a row of more pieces is summed by a block of warps in the second pass
HEAVY_PIECES = 16


def spectrum_bins(composition: str, dim: int) -> int:
    """The rfft bins of a length-``dim`` row that ``composition`` keeps:
    all ``dim // 2 + 1`` for ``ccorr_true``, the reference's truncation
    ``(dim // 2 + 1) // 2 + 1`` for ``ccorr`` (``ops/segment.py:ccorr``)."""
    full = dim // 2 + 1
    if composition == "ccorr_true":
        return full
    if composition == "ccorr":
        return full // 2 + 1
    raise ValueError(f"no spectral form of composition {composition!r}")


def spectra(t: torch.Tensor, bins: int) -> torch.Tensor:
    """The first ``bins`` bins of ``rfft(t)`` along the last axis of ``t``
    [rows, dim] as a spectrum table [rows, Kp, 2] (a zero bin added where
    ``bins`` is odd), contiguous."""
    f = torch.fft.rfft(t, dim=-1)[:, :bins]
    if bins % 2:
        f = F.pad(f, (0, 1))
    return torch.view_as_real(f.contiguous())


def from_spectra(a: torch.Tensor, bins: int, dim: int) -> torch.Tensor:
    """``irfft`` at length ``dim`` of the first ``bins`` bins of the
    spectrum table ``a``, the bins past them zero (``irfft`` pads to
    ``dim // 2 + 1``): [rows, dim]."""
    return torch.fft.irfft(torch.view_as_complex(a)[:, :bins], n=dim, dim=-1)


def loop_spectra(xh: torch.Tensor, rh_row: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """A self-loop a node: ``scale[v] * conj(xh[v]) * rh_row`` [N, Kp, 2]
    (the loop relation's spectrum ``rh_row`` [Kp, 2])."""
    prod = torch.conj(torch.view_as_complex(xh)) * torch.view_as_complex(
        rh_row) * scale[:, None]
    return torch.view_as_real(prod)


class Order(NamedTuple):
    """One order of an edge set: its edges grouped by the row of the
    output they sum into (``key``, ascending), each with the row of the
    first table (``ia``) and of the second (``ib``) it reads and its
    position in the edge set (``edge``, which indexes the per-edge scale;
    None where the order is the edge set's own); each row's run cut into
    pieces of at most ``PIECE_EDGES`` edges (``piece_begin`` [pieces + 1]:
    each piece's first edge, then the edge count; ``row_pieces`` [rows +
    1]: each row's first piece, then the piece count; ``heavy_rows``: the
    rows of more than ``HEAVY_PIECES`` pieces). ``rows`` output rows; the
    tables it reads hold at least ``a_rows`` and ``b_rows`` rows."""
    rows: int
    a_rows: int
    b_rows: int
    key: object
    ia: object
    ib: object
    edge: object
    piece_begin: object
    row_pieces: object
    heavy_rows: object

    def to(self, device) -> "Order":
        """The order's arrays as int32 tensors on ``device``."""
        return self._replace(**{
            name: None if value is None else torch.as_tensor(
                np.asarray(value), dtype=torch.int32, device=device)
            for name, value in zip(self._fields[3:], self[3:])})


def _order(key, ia, ib, rows, a_rows, b_rows) -> Order:
    """The order of the edges by ``key`` (the g++ host op's stable
    counting sort), with its pieces."""
    perm = hostops.counting_argsort(key, rows)
    counts = np.bincount(key, minlength=rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    pieces = -(-counts // PIECE_EDGES)
    row_pieces = np.concatenate([[0], np.cumsum(pieces)])
    owner = np.repeat(np.arange(rows), pieces)
    first = row_ptr[owner] + PIECE_EDGES * (
        np.arange(row_pieces[-1]) - row_pieces[owner])
    identity = np.array_equal(perm, np.arange(len(key)))
    return Order(rows, a_rows, b_rows, key[perm], ia[perm], ib[perm],
                 None if identity else perm.astype(np.int32),
                 np.concatenate([first, [len(key)]]).astype(np.int32),
                 row_pieces.astype(np.int32),
                 np.flatnonzero(pieces > HEAVY_PIECES).astype(np.int32))


def build_orders(src: np.ndarray, nbr: np.ndarray, types: np.ndarray,
                 num_nodes: int, num_types: int) -> Dict[str, Order]:
    """The three orders of an edge set (aggregation node ``src``,
    neighbour ``nbr``, relation ``types``; numpy int arrays):
    ``"src"``, the forward's sum by aggregation node of node spectra at
    ``nbr`` and relation spectra at ``types``; ``"nbr"``, the node
    spectra's gradient, a sum by neighbour of the output's gradient at
    ``src`` and relation spectra at ``types``; ``"type"``, the relation
    spectra's gradient, a sum by relation of the output's gradient at
    ``src`` and node spectra at ``nbr``. Raises on an id out of range:
    the kernel does not check them."""
    src, nbr, types = (np.ascontiguousarray(a, dtype=np.int32)
                       for a in (src, nbr, types))
    for name, ids, bound in (("src", src, num_nodes), ("nbr", nbr, num_nodes),
                             ("types", types, num_types)):
        if ids.size and (ids.min() < 0 or ids.max() >= bound):
            raise ValueError(f"build_orders: {name} outside [0, {bound})")
    N, R = num_nodes, num_types
    return {"src": _order(src, nbr, types, N, N, R),
            "nbr": _order(nbr, src, types, N, N, R),
            "type": _order(types, src, nbr, R, N, N)}


def ccorr_reduce_reference(a: torch.Tensor, b: torch.Tensor, order: Order,
                           scale: torch.Tensor, conj: bool) -> torch.Tensor:
    """Plain version of the kernel: ``out[r] = sum over the order's edges
    j of row r of scale[edge_j] * op(a[ia_j], b[ib_j])``, ``op`` the
    product of complex bins with ``a`` conjugated (``conj``) or not;
    [order.rows, Kp, 2]."""
    s = scale if order.edge is None else scale[order.edge]
    ar, ai = a[order.ia].unbind(-1)
    br, bi = b[order.ib].unbind(-1)
    if conj:
        re, im = ar * br + ai * bi, ar * bi - ai * br
    else:
        re, im = ar * br - ai * bi, ar * bi + ai * br
    vals = torch.stack([re, im], dim=-1) * s[:, None, None]
    out = a.new_zeros((order.rows,) + tuple(a.shape[1:]))
    return out.index_add_(0, order.key, vals)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = native.load("ccorr_reduce").kge_ccorr_reduce
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b, order: Order, scale) -> torch.device:
    """Refuses what the kernel does not take; returns the device."""
    device = a.device
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"ccorr_reduce: {name} must be float32, got "
                            f"{x.dtype}")
        if x.device != device:
            raise ValueError(f"ccorr_reduce: {name} is on {x.device}, a on "
                             f"{device}")
        if x.dim() != 3 or x.shape[2] != 2 or x.shape[1] % 2:
            raise ValueError(f"ccorr_reduce: {name} must be a spectrum "
                             f"table [rows, Kp, 2] with Kp even, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous() or (device.type == "cuda"
                                     and x.data_ptr() % 16):
            raise ValueError(f"ccorr_reduce: {name} must be contiguous and "
                             "16-byte aligned")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"ccorr_reduce: a has {a.shape[1]} bins, b "
                         f"{b.shape[1]}")
    if a.shape[0] < order.a_rows or b.shape[0] < order.b_rows:
        raise ValueError(f"ccorr_reduce: the order reads {order.a_rows} and "
                         f"{order.b_rows} rows, the tables hold "
                         f"{a.shape[0]} and {b.shape[0]}")
    if scale.dtype != torch.float32 or scale.dim() != 1 \
            or scale.device != device or not scale.is_contiguous():
        raise ValueError("ccorr_reduce: scale must be a contiguous float32 "
                         f"vector on {device}")
    edges = order.key.shape[0]
    if scale.shape[0] != edges:
        raise ValueError(f"ccorr_reduce: {scale.shape[0]} scales for "
                         f"{edges} edges")
    for name in order._fields[3:]:
        x = getattr(order, name)
        if x is None and name == "edge":
            continue
        if x.dtype != torch.int32 or x.device != device \
                or not x.is_contiguous():
            raise ValueError(f"ccorr_reduce: order.{name} must be a "
                             f"contiguous int32 tensor on {device}")
    if order.row_pieces.shape[0] != order.rows + 1:
        raise ValueError("ccorr_reduce: order.row_pieces must have rows + 1 "
                         "entries")
    return device


def ccorr_reduce(a: torch.Tensor, b: torch.Tensor, order: Order,
                 scale: torch.Tensor, conj: bool) -> torch.Tensor:
    """``out[r] = sum over the order's edges j of row r of scale[edge_j] *
    op(a[ia_j], b[ib_j])`` [order.rows, Kp, 2], ``op`` the product of
    complex bins with ``a`` conjugated (``conj``) or not. ``a`` and ``b``
    are spectrum tables, ``scale`` the edge set's float32 scales, the
    order's arrays int32 (``Order.to``), all on one device. CUDA tensors
    launch the kernel; CPU tensors take ``ccorr_reduce_reference``."""
    device = _check(a, b, order, scale)
    if device.type == "cpu":
        return ccorr_reduce_reference(a, b, order, scale, conj)
    if device.type != "cuda":
        raise ValueError(f"ccorr_reduce: unsupported device {device}")
    pieces = order.piece_begin.shape[0] - 1
    out = torch.empty((order.rows,) + tuple(a.shape[1:]), device=device)
    partial = torch.empty((max(pieces, 1),) + tuple(a.shape[1:]),
                          device=device)
    args = (a.data_ptr(), b.data_ptr(), order.ia.data_ptr(),
            order.ib.data_ptr(),
            0 if order.edge is None else order.edge.data_ptr(),
            scale.data_ptr(), order.piece_begin.data_ptr(),
            order.row_pieces.data_ptr(), order.heavy_rows.data_ptr(),
            partial.data_ptr(), out.data_ptr(), pieces, order.rows,
            order.heavy_rows.shape[0], HEAVY_PIECES, a.shape[1] // 2,
            int(conj), device.index,
            torch._C._cuda_getCurrentRawStream(device.index))
    err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(
            f"ccorr_reduce kernel launch failed with CUDA error {err}")
    ccorr_reduce.launches += 1
    return out


ccorr_reduce.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.is_cuda and t.data_ptr() % 16 else t


class CcorrReduce(torch.autograd.Function):
    """``A[v] = sum over the edges e of v of scale[e] * conj(xh[nbr_e]) *
    rh[type_e]`` over an edge set's orders (``build_orders``, ``Order.to``)
    [N, Kp, 2]. The scale (degree norm, dropout mask) is a constant; the
    backward reduces the gradient by neighbour into ``xh``'s and by
    relation into ``rh``'s with the same kernel."""

    @staticmethod
    def forward(ctx, xh: torch.Tensor, rh: torch.Tensor, scale: torch.Tensor,
                orders: Dict[str, Order]) -> torch.Tensor:
        ctx.save_for_backward(xh, rh, scale)
        ctx.orders = orders
        return ccorr_reduce(xh, rh, orders["src"], scale, conj=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        xh, rh, scale = ctx.saved_tensors
        grad = _aligned(grad)
        dx = dr = None
        if ctx.needs_input_grad[0]:
            dx = ccorr_reduce(grad, rh, ctx.orders["nbr"], scale, conj=True)
        if ctx.needs_input_grad[1]:
            dr = ccorr_reduce(grad, xh, ctx.orders["type"], scale, conj=False)
        return dx, dr, None, None

