"""Row-sparse Adagrad and SGD updates of an embedding table (counterpart
of ``kge_tpu/ops/pallas/row_update.py``).

Given the sorted row ids ``uniq`` [R] a batch touched and their gradient
rows ``rows_g`` [R, D], only those rows of ``table`` [V, D] (and of the
Adagrad accumulator ``sum`` [V, D]) change:

    s = sum[id] + g * g;  sum[id] = s
    table[id] += -lr * g / (sqrt(s) + eps)        (Adagrad)
    table[id] += -lr * g                          (SGD)

Unlike the JAX functions, which are pure, both update their tensors in
place, as the kernel does. A run of equal ids in ``uniq`` must carry its
gradient at its last position only (the others hold zero rows).

On a CUDA tensor ``adagrad_row_update`` and ``sgd_row_update`` launch the
hand-written kernels of ``csrc/row_update.cu`` (and count the launch in
their ``launches``); on a CPU tensor they take the plain versions
``*_reference``, line for line ``kge_tpu``'s XLA form
(``KgeOptimizer.sparse_row_update``). The kernel rounds every operation
on its own, as the plain version does, so the two give the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kge_tpu_torch.ops import native


def adagrad_row_update_reference(table: torch.Tensor, sum: torch.Tensor,
                                 uniq: torch.Tensor, rows_g: torch.Tensor,
                                 lr: float, eps: float):
    """Plain version of the Adagrad kernel, in place on ``table`` and
    ``sum``. Every position reads the rows as they were before the
    update, and equal ids add up."""
    g = rows_g
    srow = sum.index_select(0, uniq) + g * g
    u = g / (srow.sqrt() + eps)
    sum.index_add_(0, uniq, g * g)
    table.index_add_(0, uniq, -lr * u)


def sgd_row_update_reference(table: torch.Tensor, uniq: torch.Tensor,
                             rows_g: torch.Tensor, lr: float):
    """Plain version of the SGD kernel, in place on ``table``."""
    table.index_add_(0, uniq, -lr * rows_g)


@functools.lru_cache(maxsize=None)
def _library():
    lib = native.load("row_update")
    lib.kge_adagrad_row_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    lib.kge_adagrad_row_update.restype = ctypes.c_int
    lib.kge_sgd_row_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.kge_sgd_row_update.restype = ctypes.c_int
    return lib


def _check(name: str, tables, uniq, rows_g):
    """Raise unless the tables [V, D] and rows_g [R, D] are contiguous
    float32, uniq [R] int32 or int64, all on one CPU or CUDA device."""
    for label, x in (*tables.items(), ("rows_g", rows_g)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {label} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {x.dtype}")
        if x.device != rows_g.device:
            raise ValueError(
                f"{name}: {label} is on {x.device}, rows_g on {rows_g.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not isinstance(uniq, torch.Tensor) or uniq.dtype not in (
            torch.int32, torch.int64):
        raise TypeError(f"{name}: uniq must be an int32 or int64 tensor")
    if uniq.device != rows_g.device or not uniq.is_contiguous():
        raise ValueError(
            f"{name}: uniq must be contiguous and on {rows_g.device}")
    table = tables["table"]
    if (rows_g.dim() != 2 or table.dim() != 2 or uniq.dim() != 1
            or rows_g.shape[0] != uniq.shape[0]
            or rows_g.shape[1] != table.shape[1]):
        raise ValueError(
            f"{name}: table [V, D], uniq [R] and rows_g [R, D] expected, got "
            f"{tuple(table.shape)}, {tuple(uniq.shape)} and "
            f"{tuple(rows_g.shape)}")
    for label, x in tables.items():
        if x.shape != table.shape:
            raise ValueError(f"{name}: {label} {tuple(x.shape)} must have "
                             f"the table's shape {tuple(table.shape)}")
    if table.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: D must be below 2^31")
    if rows_g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows_g.device}")


def _launched(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def adagrad_row_update(table: torch.Tensor, sum: torch.Tensor,
                       uniq: torch.Tensor, rows_g: torch.Tensor, lr: float,
                       eps: float):
    """Adagrad on the ``uniq`` rows of ``table`` and ``sum``, in place.
    ``lr`` and ``eps`` are host floats. The ids are not range-checked on
    the device: the caller keeps them in ``[0, V)``."""
    _check("adagrad_row_update", dict(table=table, sum=sum), uniq, rows_g)
    if rows_g.device.type == "cpu":
        with torch.no_grad():
            adagrad_row_update_reference(table, sum, uniq, rows_g, lr, eps)
        return
    R, D = rows_g.shape
    if R == 0:
        return
    lib = _library()
    with torch.cuda.device(rows_g.device):
        err = lib.kge_adagrad_row_update(
            table.data_ptr(), sum.data_ptr(), uniq.data_ptr(),
            rows_g.data_ptr(), R, D, uniq.element_size(), -float(lr),
            float(eps), torch.cuda.current_stream().cuda_stream)
    _launched(err, "adagrad_row_update")
    adagrad_row_update.launches += 1


def sgd_row_update(table: torch.Tensor, uniq: torch.Tensor,
                   rows_g: torch.Tensor, lr: float):
    """Plain SGD on the ``uniq`` rows of ``table``, in place; as
    ``adagrad_row_update`` otherwise."""
    _check("sgd_row_update", dict(table=table), uniq, rows_g)
    if rows_g.device.type == "cpu":
        with torch.no_grad():
            sgd_row_update_reference(table, uniq, rows_g, lr)
        return
    R, D = rows_g.shape
    if R == 0:
        return
    lib = _library()
    with torch.cuda.device(rows_g.device):
        err = lib.kge_sgd_row_update(
            table.data_ptr(), uniq.data_ptr(), rows_g.data_ptr(), R, D,
            uniq.element_size(), -float(lr),
            torch.cuda.current_stream().cuda_stream)
    _launched(err, "sgd_row_update")
    sgd_row_update.launches += 1


adagrad_row_update.launches = 0
sgd_row_update.launches = 0
