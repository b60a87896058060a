"""Collectives with autograd (what GSPMD inserts in ``kge_tpu``, written
out):

- ``vocab_lookup``: rows of a table sharded over ``model``. Forward:
  gather the owned rows, zero the others, ``all_reduce`` over the model
  group. Backward: the owned rows' gradient only. Every model rank
  computes the same loss from the reduced rows, so its output gradient
  is the same on each; reducing it again would count it ``model``
  times;
- ``gather_table``: the whole table from its row blocks (``all_gather``
  over ``model``); backward keeps this rank's block of the gradient;
- ``model_sum``: a sum over ``model`` of terms the ranks computed for
  their own rows (a whole-table penalty); backward is the identity, for
  the same reason as the lookup's;
- ``data_sum``: a sum over ``data`` of partial sums of the global batch
  (batch-norm statistics). Each data rank's loss is its part of the
  global one, so the backward sums the output gradients over ``data``
  too (the adjoint of a sum of partial losses).

Autograd functions take the group as an argument; with one rank in the
group each is the identity on its input.
"""

from __future__ import annotations

import torch

from kge_tpu_torch.parallel.distributed import all_gather, all_reduce


class _VocabLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, indexes, lo, group):
        flat = indexes.reshape(-1)
        owned = (flat >= lo) & (flat < lo + shard.shape[0])
        local = torch.where(owned, flat - lo, 0)
        rows = torch.index_select(shard, 0, local)
        rows = rows * owned[:, None].to(rows.dtype)
        all_reduce(rows, group)
        ctx.save_for_backward(local, owned)
        ctx.shard_shape = shard.shape
        return rows.reshape(*indexes.shape, shard.shape[1])

    @staticmethod
    def backward(ctx, grad):
        local, owned = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        g = g * owned[:, None].to(g.dtype)
        out = torch.zeros(ctx.shard_shape, dtype=g.dtype, device=g.device)
        out.index_add_(0, local, g)
        return out, None, None, None


def vocab_lookup(shard: torch.Tensor, indexes: torch.Tensor, lo: int,
                 group) -> torch.Tensor:
    """Rows ``indexes`` of the table whose rows ``[lo, lo + len(shard))``
    this rank holds as ``shard`` ([..., D] output, on every rank of the
    model ``group``)."""
    return _VocabLookup.apply(shard, indexes, lo, group)


class _GatherTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, index):
        ctx.rows, ctx.index = shard.shape[0], index
        return torch.cat(all_gather(shard, group), dim=0)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def gather_table(shard: torch.Tensor, group, index: int) -> torch.Tensor:
    """The whole table from every model rank's block (``index``: this
    rank's place in the model group)."""
    return _GatherTable.apply(shard, group, index)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's ``x``; backward is
    the identity (the loss above it is replicated over the group)."""
    return _ModelSum.apply(x, group)


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def data_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the data group of each rank's partial ``x``;
    backward sums the gradients over the group too (each rank's loss is
    a part of the global batch's)."""
    return _DataSum.apply(x, group)
