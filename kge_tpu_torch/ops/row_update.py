"""Row-sparse Adagrad and SGD updates of embedding tables (counterpart of
``kge_tpu/ops/pallas/row_update.py``).

Given the sorted row ids ``uniq`` [R] a batch touched and their gradient
rows ``rows_g`` [R, D], only those rows of ``table`` [V, D] (and of the
Adagrad accumulator ``sum`` [V, D]) change:

    s = sum[id] + g * g;  sum[id] = s
    table[id] += -lr * g / (sqrt(s) + eps)        (Adagrad)
    table[id] += -lr * g                          (SGD)

Unlike the JAX functions, which are pure, these update their tensors in
place, as the kernel does. A run of equal ids in ``uniq`` must carry its
gradient at its last position only (the others hold zero rows).

``row_update_groups`` updates several tables at once, each a group
``(table, sum, uniq, rows_g, lr, eps)`` with its own learning rate and
eps (``sum`` None and ``eps`` unused for SGD): on CUDA tensors one launch
of the hand-written kernel of ``csrc/row_update.cu`` for up to
``MAX_GROUPS`` tables, so a training step updates every sparse table with
one launch and one host call (``KgeOptimizer.sparse_row_update``). The
learning rate is a 0-d float32 tensor on the tables' device, which the
kernel reads there (so a CUDA graph of a training step reads the rate
the trainer writes before each epoch), or a host float, which the
wrapper puts into such a tensor first; either gives the bits of
``float32(-lr)``. ``eps`` is a host float.
``adagrad_row_update`` and ``sgd_row_update`` are its one-table calls.
Each launch counts one in ``adagrad_row_update.launches`` or
``sgd_row_update.launches``. On CPU tensors the plain versions
``*_reference`` run instead, line for line ``kge_tpu``'s XLA form
(``KgeOptimizer.sparse_row_update``), one table after the other. The
kernel rounds every operation on its own, as the plain version does, so
the two give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional, Sequence, Tuple, Union

import torch

from kge_tpu_torch.ops import native

#: tables one launch updates, at most (the kernel's parameter struct)
MAX_GROUPS = 4
_ID_TYPES = (torch.int32, torch.int64)

Group = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
              torch.Tensor, Union[float, torch.Tensor], float]

#: n groups as the kernel's entry point reads them (its ``HostGroup``):
#: table, sum, uniq, rows_g and lr pointers, R, D, index bytes, eps
_PACKED = [struct.Struct("<" + "8qf4x" * n) for n in range(MAX_GROUPS + 1)]


def adagrad_row_update_reference(table: torch.Tensor, sum: torch.Tensor,
                                 uniq: torch.Tensor, rows_g: torch.Tensor,
                                 lr: Union[float, torch.Tensor], eps: float):
    """Plain version of the Adagrad kernel, in place on ``table`` and
    ``sum``. Every position reads the rows as they were before the
    update, and equal ids add up. ``lr`` a float or a 0-d float32
    tensor: both multiply as float32."""
    g = rows_g
    srow = sum.index_select(0, uniq) + g * g
    u = g / (srow.sqrt() + eps)
    sum.index_add_(0, uniq, g * g)
    table.index_add_(0, uniq, -lr * u)


def sgd_row_update_reference(table: torch.Tensor, uniq: torch.Tensor,
                             rows_g: torch.Tensor,
                             lr: Union[float, torch.Tensor]):
    """Plain version of the SGD kernel, in place on ``table``."""
    table.index_add_(0, uniq, -lr * rows_g)


def row_update_groups_reference(optimizer: str, groups: Sequence[Group]):
    """Plain version of a grouped launch: the groups one after the other."""
    for table, ssum, uniq, rows_g, lr, eps in groups:
        if optimizer == "adagrad":
            adagrad_row_update_reference(table, ssum, uniq, rows_g, lr, eps)
        else:
            sgd_row_update_reference(table, uniq, rows_g, lr)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = native.load("row_update").kge_row_update
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, table, ssum, uniq, rows_g) -> Tuple[int, int,
                                                          torch.device]:
    """Refuses a group the kernel does not take; returns (R, D, device).
    table (and sum, unless None) [V, D] and rows_g [R, D] must be
    contiguous float32, uniq [R] int32 or int64, all on one device. Reads
    each attribute once."""
    device = None
    for label, x in (("rows_g", rows_g), ("table", table), ("sum", ssum)):
        if x is None and label == "sum":
            continue
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {label} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {x.dtype}")
        x_device = x.device
        device = device or x_device
        if x_device != device:
            raise ValueError(
                f"{name}: {label} is on {x_device}, rows_g on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not isinstance(uniq, torch.Tensor) or uniq.dtype not in _ID_TYPES:
        raise TypeError(f"{name}: uniq must be an int32 or int64 tensor")
    if uniq.device != device or not uniq.is_contiguous():
        raise ValueError(f"{name}: uniq must be contiguous and on {device}")
    table_shape, g_shape = tuple(table.shape), tuple(rows_g.shape)
    uniq_shape = tuple(uniq.shape)
    if (len(g_shape) != 2 or len(table_shape) != 2 or len(uniq_shape) != 1
            or g_shape[0] != uniq_shape[0] or g_shape[1] != table_shape[1]):
        raise ValueError(
            f"{name}: table [V, D], uniq [R] and rows_g [R, D] expected, got "
            f"{table_shape}, {uniq_shape} and {g_shape}")
    if ssum is not None and tuple(ssum.shape) != table_shape:
        raise ValueError(f"{name}: sum {tuple(ssum.shape)} must have the "
                         f"table's shape {table_shape}")
    R, D = g_shape
    if D >= 2 ** 31:
        raise ValueError(f"{name}: D must be below 2^31")
    return R, D, device


def _device_lr(name: str, lr, device: torch.device) -> torch.Tensor:
    """The learning rate as the kernel reads it: a 0-d float32 tensor on
    ``device`` (a host float is filled into a new one)."""
    if not isinstance(lr, torch.Tensor):
        return torch.full((), float(lr), dtype=torch.float32, device=device)
    if lr.dtype != torch.float32 or lr.dim() != 0 or lr.device != device:
        raise ValueError(f"{name}: lr must be a float or a 0-d float32 "
                         f"tensor on {device}, got {lr.dtype} "
                         f"{tuple(lr.shape)} on {lr.device}")
    return lr


def row_update_groups(optimizer: str, groups: Sequence[Group],
                      name: str = "row_update_groups"):
    """Adagrad (``optimizer`` "adagrad": every group's ``sum`` a tensor)
    or SGD ("sgd": ``sum`` None, ``eps`` unused) on the ``uniq`` rows of
    each group's table, in place; ``lr`` a host float or a 0-d float32
    tensor on the tables' device, ``eps`` a host float. On CUDA tensors
    one launch for all groups (none when every group has R = 0), on the
    current stream, with no host sync. The ids are not range-checked on
    the device: the caller keeps them in ``[0, V)``."""
    if optimizer not in ("adagrad", "sgd"):
        raise ValueError(f"{name}: optimizer must be adagrad or sgd, got "
                         f"{optimizer!r}")
    adagrad = optimizer == "adagrad"
    n = len(groups)
    if n > MAX_GROUPS:
        raise ValueError(f"{name}: {n} groups, the kernel takes at most "
                         f"{MAX_GROUPS}")
    device, cuda, fields, rows, rates = None, False, [], 0, []
    for k, (table, ssum, uniq, rows_g, lr, eps) in enumerate(groups):
        if adagrad and ssum is None:
            raise TypeError(f"{name}: Adagrad needs a sum tensor")
        R, D, group_device = _check(name, table, ssum if adagrad else None,
                                    uniq, rows_g)
        if device is None:
            device = group_device
            cuda = device.type == "cuda"
            if not cuda and device.type != "cpu":
                raise ValueError(f"{name}: unsupported device {device}")
        elif group_device != device:
            raise ValueError(f"{name}: group {k} is on {group_device}, "
                             f"group 0 on {device}")
        if cuda:
            # kept alive until the launch is enqueued
            rates.append(_device_lr(name, lr, device))
            fields += (table.data_ptr(), ssum.data_ptr() if adagrad else 0,
                       uniq.data_ptr(), rows_g.data_ptr(),
                       rates[-1].data_ptr(), R, D, uniq.element_size(),
                       float(eps) if adagrad else 0.0)
            rows += R
    if device is None:
        return
    if not cuda:
        with torch.no_grad():
            row_update_groups_reference(optimizer, groups)
        return
    if rows == 0:
        return
    # the kernel's entry point switches to the tensors' device itself; the
    # raw stream handle (as torch's generated Triton launchers take it)
    # saves the torch.cuda.Stream object that current_stream() builds,
    # 4-5 us of host time a call on the H100 machine's host
    err = _kernel()(int(adagrad), n, _PACKED[n].pack(*fields), device.index,
                    torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(
            f"{name}: row_update kernel launch failed with CUDA error {err}")
    (adagrad_row_update if adagrad else sgd_row_update).launches += 1


def adagrad_row_update(table: torch.Tensor, sum: torch.Tensor,
                       uniq: torch.Tensor, rows_g: torch.Tensor,
                       lr: Union[float, torch.Tensor], eps: float):
    """Adagrad on the ``uniq`` rows of ``table`` and ``sum``, in place: a
    one-group ``row_update_groups``."""
    row_update_groups("adagrad", ((table, sum, uniq, rows_g, lr, eps),),
                      "adagrad_row_update")


def sgd_row_update(table: torch.Tensor, uniq: torch.Tensor,
                   rows_g: torch.Tensor, lr: Union[float, torch.Tensor]):
    """Plain SGD on the ``uniq`` rows of ``table``, in place: a one-group
    ``row_update_groups``."""
    row_update_groups("sgd", ((table, None, uniq, rows_g, lr, 0.0),),
                      "sgd_row_update")


adagrad_row_update.launches = 0
sgd_row_update.launches = 0
