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
  too (the adjoint of a sum of partial losses). Over ``model`` it is the
  sum of the R-GNN halo route's row blocks (batch-norm statistics over
  all nodes), whose consumers' gradients are partial alike.

The R-GNN encoder's halo route (``models/rgnn``) computes each layer on
this rank's row block of the nodes, between the entity table's own block
and ``gather_table``: there every rank holds the gradient of its own
rows only, so

- ``halo_exchange``: the boundary rows of the other ranks, one
  ``all_to_all`` of each rank's ``send`` rows; backward is the reverse
  exchange and an ``index_add_`` into the block's gradient;
- ``enter_blocks``: replicated tensors (a layer's weights) that the
  block computation reads; forward the identity, backward sums their
  gradients over ``model`` (each rank's covers its rows only).

Autograd functions take the group as an argument; with one rank in the
group each is the identity on its input.
"""

from __future__ import annotations

import torch

from kge_tpu_torch.parallel.distributed import (
    all_gather, all_reduce, all_to_all,
)


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
    """The sum over ``group`` of each rank's partial ``x``; backward sums
    the gradients over the group too (each rank's loss is a part of the
    global batch's, or its rows a block of the nodes')."""
    return _DataSum.apply(x, group)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, send, group):
        ctx.save_for_backward(send)
        ctx.group, ctx.rows = group, local.shape[0]
        return all_to_all(local.index_select(0, send.reshape(-1)), group)

    @staticmethod
    def backward(ctx, grad):
        (send,) = ctx.saved_tensors
        back = all_to_all(grad, ctx.group)
        out = grad.new_zeros((ctx.rows, grad.shape[1]))
        return out.index_add_(0, send.reshape(-1), back), None, None


def halo_exchange(local: torch.Tensor, send: torch.Tensor,
                  group) -> torch.Tensor:
    """``[P * rmax, d]``: block q holds the rows of rank q's block that
    this rank needs (rank q's ``send[p]``); this rank sends
    ``local[send[q]]`` to each rank q (``send``: [P, rmax] local row
    ids)."""
    halo_exchange.calls += 1
    return _HaloExchange.apply(local, send, group)


#: the forward exchanges so far (a test reads that a route engaged)
halo_exchange.calls = 0


class _EnterBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                          ctx.group)
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return (None, *out)


def enter_blocks(tensors, group) -> tuple:
    """``tensors`` as they are, their gradients summed over ``group``
    (one collective): the replicated inputs of a computation each rank
    runs on its own row block."""
    return _EnterBlocks.apply(group, *tensors)
