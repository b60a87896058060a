"""Relational GNN layers (counterpart of ``kge_tpu/models/rgnn/layers.py``;
reference: kge/model/embedder/rgnn_encoder.py).

Three layer families, each an ``nn.Module`` whose parameters carry the
names of ``kge_tpu``'s params dict (``w_in_h0``, ``loop_rel``, ...):

- ``MessagePassingLayer`` (CompGCN/RAGAT): gather neighbor and relation
  embeddings, compose, transform with a per-mode weight, and
  ``segment_sum`` back to the nodes. Edge and self-edge dropout are 0/1
  edge masks folded into the messages. Linear compositions without a
  message weight transform the [N, d] table once and gather after
  (``hoistable``). Per-relation weights (basis/block decompositions) run
  as one batched gather, one ``einsum``/``bmm`` over the padded relation
  buckets and one ``index_add_`` (``kge_tpu`` scans the buckets one by
  one: the same sum in another order).
- ``RgcnLayer`` (torch-rgcn): sum_r A_r X W_r with per-(relation, node)
  mean normalization, batched over the buckets in the same way.
- ``WeightedGCNLayer`` (W-GCN/SACN): the per-relation scalar alpha
  collapses the relational adjacency to one symmetric matrix.

``kge_tpu``'s TPU layouts (padded-CSR row blocks, the dense adjacency,
the sharded halo exchange) are not ported: the layers aggregate over the
edge list, which gives the numbers of ``kge_tpu``'s message path (and of
its row-block path up to summation order). Batch-norm running statistics
are model state, read from ``Ctx.state`` and written to ``Ctx.updates``
under ``f"{name}_bn"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch.models.api import Ctx
from kge_tpu_torch.models.conve import batch_norm
from kge_tpu_torch.models.init import initialize
from kge_tpu_torch.ops.segment import (
    composition_fn,
    degree_norm,
    schlichtkrull_normal_,
    schlichtkrull_uniform_,
    segment_sum,
    wgcn_uniform_,
)


def init_weight(generator: torch.Generator, shape, init_name: str,
                fans=None) -> torch.Tensor:
    """Initializer lookup covering torch.nn.init names plus the RGCN/WGCN
    schemes (reference: rgnn_encoder.py _find_init)."""
    if init_name == "schlichtkrull_normal_":
        return schlichtkrull_normal_(generator, shape, fans=fans)
    if init_name == "schlichtkrull_uniform_":
        return schlichtkrull_uniform_(generator, shape, fans=fans)
    if init_name == "wgcn_uniform_":
        return wgcn_uniform_(generator, shape)
    return initialize(generator, shape, init_name, {})


def batch_norm_affine(x: torch.Tensor, layer: nn.Module, state_key: str,
                      ctx: Ctx) -> torch.Tensor:
    """BatchNorm1d with torch semantics (unbiased running variance,
    momentum 0.1), its affine scale and bias the layer's ``bn_scale`` and
    ``bn_bias``."""
    x = batch_norm(x, state_key, ctx, reduce_axes=(0,))
    return x * layer.bn_scale + layer.bn_bias


def keep_mask(ctx: Ctx, keep: float, shape, device, dtype) -> torch.Tensor:
    """A 0/1 mask of Bernoulli(keep) draws from the Ctx's generator."""
    if ctx.generator is None:
        raise ValueError("this computation needs a generator in its Ctx")
    return (torch.rand(shape, generator=ctx.generator, device=device)
            < keep).to(dtype)


class RgnnLayerBase(nn.Module):
    """Shared bits: dims, init names, edge/self-edge dropout masks, and
    parameter creation (drawn from ``generator``, or left unset with
    ``init_for_load_only``)."""

    def __init__(self, name: str, dataset, in_dim: int, out_dim: int,
                 options: Dict[str, Any], *, device: torch.device,
                 generator: Optional[torch.Generator],
                 init_for_load_only: bool):
        super().__init__()
        self.name = name
        self.num_entities = dataset.num_entities()
        self.num_base_relations = dataset.num_relations()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.weight_init = options["weight_init"]
        self.bias_ = options["bias"]
        self.bias_init = options.get("bias_init", "zeros_")
        self.edge_dropout = options["edge_dropout"]
        self.self_edge_dropout = options["self_edge_dropout"]
        self._device = device
        self._generator = generator
        self._load_only = init_for_load_only

    def _param(self, key: str, shape, draw):
        """Register parameter ``key``: ``draw(generator)``, or an unset
        tensor of ``shape`` for a model that is loaded afterwards."""
        if self._load_only:
            value = torch.empty(shape, dtype=torch.float32,
                                device=self._device)
        else:
            value = draw(self._generator).to(self._device)
        setattr(self, key, nn.Parameter(value, requires_grad=False))

    def _init(self, key: str, shape, init_name: str, fans=None):
        self._param(key, shape,
                    lambda g: init_weight(g, shape, init_name, fans=fans))

    def _edge_masks(self, ctx: Ctx, num_edges: int, x: torch.Tensor,
                    edge_orig: Optional[torch.Tensor]):
        """0/1 keep-masks for edges and self-loops. One Bernoulli a
        triple, shared by its direct and inverse edge through
        ``edge_orig`` (the triple of each edge position; reference:
        rgnn_encoder.py:504-511); the self-loops' drawn apart."""
        opts = dict(device=x.device, dtype=x.dtype)
        if ctx.train and self.edge_dropout > 0:
            half = keep_mask(ctx, 1.0 - self.edge_dropout, (num_edges // 2,),
                             **opts)
            edge_mask = (half[edge_orig] if edge_orig is not None
                         else torch.cat([half, half]))
        else:
            edge_mask = torch.ones(num_edges, **opts)
        if ctx.train and self.self_edge_dropout > 0:
            self_mask = keep_mask(ctx, 1.0 - self.self_edge_dropout,
                                  (self.num_entities,), **opts)
        else:
            self_mask = torch.ones(self.num_entities, **opts)
        return edge_mask, self_mask

    def init_state(self) -> Dict[str, Any]:
        return {}

    def _bn_state(self) -> Dict[str, Any]:
        return {f"{self.name}_bn": {
            "mean": torch.zeros(self.out_dim, device=self._device),
            "var": torch.ones(self.out_dim, device=self._device),
        }}


def rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for an index of any shape, by ``index_select``:
    its backward is an ``index_add_``, where advanced indexing's sorts
    the indices and sums each run of one index in one warp (a hub node's
    thousands of edges, a frequent relation's, in sequence)."""
    out = table.index_select(0, index.reshape(-1))
    return out.reshape(*index.shape, *table.shape[1:])


def _bucket_edges(graph: Dict[str, Any]):
    """The padded relation buckets as edge positions: (positions clamped
    to a real edge, 0/1 validity) of [M, Emax]."""
    buckets = graph["rel_buckets"]
    return buckets.clamp(min=0), buckets >= 0


class MessagePassingLayer(RgnnLayerBase):
    """CompGCN/RAGAT-style layer (reference: rgnn_encoder.py:15-598)."""

    def __init__(self, name, dataset, in_dim, out_dim, options,
                 first_layer: bool, **kwargs):
        super().__init__(name, dataset, in_dim, out_dim, options,
                         **kwargs)
        self.num_relations = dataset.num_relations() * 2  # with inverses
        mp = options["message_passing_args"]
        self.propagation = mp["propagation"]
        self.message_weight = mp["message_weight"]
        self.learned_relation_weight = mp["learned_relation_weight"]
        self.use_edge_norm = mp["edge_norm"]
        self.prop_dropout = mp["emb_propagation_dropout"]
        self.attention = mp["attention"]
        self.num_heads = mp["num_heads"] if self.attention else 1
        composition = mp["composition"]
        if self.message_weight and not composition.endswith("weighted"):
            composition += "_weighted"
        if composition.endswith("weighted"):
            self.message_weight = True
        self.composition_name = composition
        self.composition = composition_fn(composition)
        # linear compositions commute with the mode weight: (h_j - h_r) @ W
        # == h_j @ W - h_r @ W, so the matmul runs once on the [N, d] table
        # and the per-edge work becomes gathers
        self.hoistable = (
            composition in ("neighbor", "neighbour", "sub")
            and not self.message_weight
        )
        self.rel_transformation = options["rel_transformation"]
        self.weight_decomposition = options["weight_decomposition"]
        self.num_blocks_or_bases = options["num_blocks_or_bases"]
        # relation basis decomposition applies to the first layer only
        if self.weight_decomposition == "relation_basis" and not first_layer:
            self.weight_decomposition = "None"
        if self.weight_decomposition in ("basis", "block"):
            if self.propagation != "per_relation":
                raise RuntimeError(
                    "weight decomposition requires per_relation propagation"
                )
            self.propagation = f"per_relation_{self.weight_decomposition}"
        elif self.propagation == "per_relation":
            raise NotImplementedError(
                "per_relation propagation requires weight_decomposition "
                "basis or block"
            )
        if self.propagation.startswith("per_relation") and self.message_weight:
            raise NotImplementedError(
                "message_weight is not supported with per_relation "
                "propagation"
            )
        if self.attention:
            self.use_edge_norm = False
        if self.propagation == "single":
            self.modes = [""]
            self.self_edge_weight = False
        elif self.propagation == "single_with_self_edge_weight":
            self.modes = ["", "loop"]
            self.self_edge_weight = True
        elif self.propagation == "direction":
            self.modes = ["in", "out", "loop"]
            self.self_edge_weight = True
        elif self.propagation.startswith("per_relation"):
            self.modes = ["per_relation", "loop"]
            self.self_edge_weight = True
        else:
            raise NotImplementedError(
                f"propagation type {self.propagation} not supported"
            )
        self._init_params()

    # ------------------------------------------------------------------ params

    def _init_params(self):
        d_in, d_out, R = self.in_dim, self.out_dim, self.num_relations
        if self.bias_:
            self._init("bias", (d_out,), self.bias_init)
        if not self.propagation.startswith("per_relation"):
            self._param("bn_scale", (d_out,), lambda g: torch.ones(d_out))
            self._param("bn_bias", (d_out,), lambda g: torch.zeros(d_out))
        self._init("loop_rel", (1, d_in), self.weight_init)
        if self.rel_transformation == "linear":
            self._init("w_rel", (d_in, d_out), self.weight_init)
        if self.learned_relation_weight:
            self._init("alpha", (R + 1, 1), "normal_")
        if self.weight_decomposition == "relation_basis":
            b = self.num_blocks_or_bases
            if b < 1:
                raise ValueError("relation_basis needs >= 1 basis")
            self._init("basis_vectors", (b, d_in), self.weight_init)
            self._init("relation_basis_weights", (R, b), self.weight_init)
        if self.propagation == "per_relation_basis":
            b = self.num_blocks_or_bases
            self._init("bases", (b, d_in, d_out), self.weight_init)
            self._init("comps", (R, b), self.weight_init)
            self._init("w_loop", (d_in, d_out), self.weight_init)
        elif self.propagation == "per_relation_block":
            nb = self.num_blocks_or_bases
            bi, ri = divmod(d_in, nb)
            bo, ro = divmod(d_out, nb)
            if ri or ro:
                raise RuntimeError("weight dims not divisible by blocks")
            fans = [R // 2, bi]
            self._init("w_blocks", (R, nb, bi, bo), "schlichtkrull_normal_",
                       fans)
            self._init("w_loop", (d_in, d_out), "schlichtkrull_normal_", fans)
        else:
            for head in range(self.num_heads):
                for mode in self.modes:
                    self._init(f"w_{mode}_h{head}", (d_in, d_out),
                               self.weight_init)
        for head in range(self.num_heads):
            if self.message_weight:
                self._init(f"w_msgweight_h{head}", (R + 1, d_in),
                           self.weight_init)
            if self.attention:
                self._init(f"w_att_h{head}", (d_out, 1), self.weight_init)

    def init_state(self):
        if not self.propagation.startswith("per_relation"):
            return self._bn_state()
        return {}

    # ------------------------------------------------------------------ forward

    def _edge_messages(self, x, r_full, nbr, types, scale, weight,
                       head: int, is_loop: bool) -> torch.Tensor:
        """Per-edge messages: compose, transform, weight, scale (the edge
        norm or the keep-mask)."""
        if self.hoistable:
            # transform the node/relation tables once, gather after
            xw = x @ weight
            if is_loop:
                msg = xw
                if self.composition_name == "sub":
                    msg = msg - (r_full[-1] @ weight)[None, :]
            else:
                msg = rows(xw, nbr)
                if self.composition_name == "sub":
                    msg = msg - rows(r_full @ weight, types)
        else:
            # no composition reads h_i, the aggregation node's embedding
            h_j = x if is_loop else rows(x, nbr)
            mw = (rows(getattr(self, f"w_msgweight_h{head}"), types)
                  if self.message_weight else None)
            msg = self.composition(None, h_j, rows(r_full, types), mw) @ weight
        if self.learned_relation_weight and not is_loop:
            msg = msg * rows(self.alpha, types)
        return msg * scale[:, None]

    def _per_relation_out(self, x, r_full, graph, edge_mask,
                          ctx: Ctx) -> torch.Tensor:
        """Every relation's messages with its own weight, batched over the
        padded relation buckets: one gather, one einsum/bmm, one
        index_add_."""
        edge_index = graph["edge_index"]
        src_all, nbr_all = edge_index[0], edge_index[1]
        N = self.num_entities
        pos, valid = _bucket_edges(graph)
        rels = graph["rel_bucket_ids"]
        src, nbr = src_all[pos], nbr_all[pos]
        mask = valid.to(x.dtype) * edge_mask[pos]
        h_j = rows(x, nbr)                               # [M, Emax, d]
        composed = self.composition(None, h_j, rows(r_full, rels)[:, None],
                                    None)
        M, Emax = pos.shape
        if self.propagation == "per_relation_block":
            nb = self.num_blocks_or_bases
            msg = torch.einsum(
                "mebi,mbio->mebo",
                composed.reshape(M, Emax, nb, self.in_dim // nb),
                rows(self.w_blocks, rels),
            ).reshape(M, Emax, self.out_dim)
        else:
            w = torch.einsum("mb,bio->mio", rows(self.comps, rels),
                             self.bases)
            msg = torch.bmm(composed, w)
        if self.learned_relation_weight:
            msg = msg * rows(self.alpha, rels)[:, None, :]
        if self.use_edge_norm:
            # the degrees over the whole graph (reference per_relation
            # branch)
            deg = segment_sum(edge_mask, src_all, N)
            deg_inv = torch.where(
                deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)
            msg = msg * (deg_inv[src] * deg_inv[nbr] * mask)[..., None]
        else:
            msg = msg * mask[..., None]
        if ctx.train and self.prop_dropout > 0:
            # the reference drops each relation's aggregated [N, d]
            # message: one mask per (relation, aggregation node), which
            # the (relation, node) group ids address
            keep = 1.0 - self.prop_dropout
            groups = graph["rgcn_groups_vert"]
            drop = keep_mask(ctx, keep,
                             (graph["rgcn_num_groups_vert"], self.out_dim),
                             x.device, x.dtype)
            msg = msg * drop[groups[pos]] / keep
        return segment_sum(msg.reshape(M * Emax, self.out_dim),
                           src.reshape(-1), N)

    def forward(self, x, r, graph, ctx: Ctx):
        edge_index, edge_type = graph["edge_index"], graph["edge_type"]
        E = edge_index.shape[1]
        N = self.num_entities
        if self.weight_decomposition == "relation_basis":
            r = self.relation_basis_weights @ self.basis_vectors
        r_full = torch.cat([r, self.loop_rel], dim=0)
        edge_mask, self_mask = self._edge_masks(ctx, E, x,
                                                graph.get("edge_orig"))
        loop_idx = torch.arange(N, device=x.device)
        loop_types = torch.full((N,), r_full.shape[0] - 1, device=x.device,
                                dtype=edge_type.dtype)

        def mode_edges(mode):
            """(src, nbr, types, mask, is_loop)."""
            if mode in ("in", "out"):
                sl = slice(0, E // 2) if mode == "in" else slice(E // 2, E)
                return (edge_index[0, sl], edge_index[1, sl], edge_type[sl],
                        edge_mask[sl], False)
            if mode == "loop":
                return loop_idx, loop_idx, loop_types, self_mask, True
            # "": all edges; without a self-edge weight the loops ride along
            if not self.self_edge_weight:
                return (torch.cat([edge_index[0], loop_idx]),
                        torch.cat([edge_index[1], loop_idx]),
                        torch.cat([edge_type, loop_types]),
                        torch.cat([edge_mask, self_mask]), False)
            return edge_index[0], edge_index[1], edge_type, edge_mask, False

        num_modes = len(self.modes)
        head_outputs = []
        for head in range(self.num_heads):
            if self.propagation.startswith("per_relation"):
                out = self._per_relation_out(x, r_full, graph, edge_mask, ctx)
                # the self-loop mode with its own weight
                composed = self.composition(None, x, self.loop_rel, None)
                head_outputs.append(
                    out + (composed @ self.w_loop) * self_mask[:, None])
                continue
            per_mode = []
            for mode in self.modes:
                src, nbr, types, mask, is_loop = mode_edges(mode)
                scale = mask
                if self.use_edge_norm and not is_loop:
                    scale = degree_norm(src, nbr, mask, N)
                msg = self._edge_messages(
                    x, r_full, nbr, types, scale,
                    getattr(self, f"w_{mode}_h{head}"), head, is_loop)
                if self.attention:
                    per_mode.append((msg, src, mask))
                    continue
                agg = msg if is_loop else segment_sum(msg, src, N)
                if not is_loop:
                    agg = ctx.dropout(agg, self.prop_dropout)
                if self.propagation == "direction":
                    agg = agg / num_modes
                per_mode.append(agg)
            if self.attention:
                # RAGAT: an edge softmax per target node
                messages = torch.cat([m for m, _, _ in per_mode])
                dst = torch.cat([s for _, s, _ in per_mode])
                emask = torch.cat([m for _, _, m in per_mode])
                att_w = getattr(self, f"w_att_h{head}")
                scores = -F.leaky_relu((messages @ att_w).reshape(-1),
                                       negative_slope=0.2)
                # dropped edges leave the softmax entirely (the reference
                # removes them from edge_index): no exp(0) in the
                # denominator
                edge_exp = (torch.exp(scores) * (emask > 0))[:, None]
                entity_exp = segment_sum(edge_exp, dst, N)
                entity_exp = torch.where(entity_exp == 0.0, 1.0, entity_exp)
                # the propagation dropout falls on the numerator only
                edge_exp = ctx.dropout(edge_exp, self.prop_dropout)
                weighted = segment_sum(edge_exp * messages, dst, N)
                head_outputs.append(weighted / entity_exp)
            else:
                out = per_mode[0]
                for m in per_mode[1:]:
                    out = out + m
                head_outputs.append(out)

        out = (head_outputs[0] / self.num_heads if self.attention
               else head_outputs[0])
        for h in head_outputs[1:]:
            out = out + h / self.num_heads
        if self.bias_:
            out = out + self.bias
        if not self.propagation.startswith("per_relation"):
            out = batch_norm_affine(out, self, f"{self.name}_bn", ctx)
        # relation transform (drops the loop relation row)
        if self.rel_transformation == "self":
            rel = r_full[:-1]
        elif self.rel_transformation == "linear":
            rel = (r_full @ self.w_rel)[:-1]
        else:
            raise NotImplementedError(
                f"rel_transformation {self.rel_transformation}"
            )
        return out, rel


class RgcnLayer(RgnnLayerBase):
    """R-GCN layer: sum_r A_r X W_r with per-(relation, node) mean
    normalization (reference TorchRgcnLayer, rgnn_encoder.py:600-906).

    Both of the reference's sparse stackings normalize each edge by
    1 / |{same-relation edges of its aggregation node}|, the paper's
    1/c_{i,r}; ``torch_rgcn_args.vertical_stacking`` is accepted and has
    no effect, as in ``kge_tpu``."""

    def __init__(self, name, dataset, in_dim, out_dim, options,
                 **kwargs):
        super().__init__(name, dataset, in_dim, out_dim, options,
                         **kwargs)
        self.num_relations = dataset.num_relations() * 2 + 1  # + self edge
        self.weight_decomposition = options["weight_decomposition"]
        self.num_blocks_or_bases = options["num_blocks_or_bases"]
        d_in, d_out, R = in_dim, out_dim, self.num_relations
        if self.bias_:
            self._init("bias", (d_out,), self.bias_init)
        if self.weight_decomposition == "basis":
            if self.num_blocks_or_bases <= 0:
                raise ValueError("basis decomposition needs > 0 bases")
            self._init("bases", (self.num_blocks_or_bases, d_in, d_out),
                       self.weight_init)
            self._init("comps", (R, self.num_blocks_or_bases),
                       self.weight_init)
        elif self.weight_decomposition == "block":
            nb = self.num_blocks_or_bases
            bi, ri = divmod(d_in, nb)
            bo, ro = divmod(d_out, nb)
            if ri or ro:
                raise RuntimeError("weight dims not divisible by blocks")
            fans = [self.num_base_relations, bi]
            self._init("blocks", (R - 1, nb, bi, bo), "schlichtkrull_normal_",
                       fans)
            self._init("block_self", (d_in, d_out), "schlichtkrull_normal_",
                       fans)
        else:
            self._init("weights", (R, d_in, d_out), self.weight_init)

    def forward(self, x, r, graph, ctx: Ctx):
        edge_index = graph["edge_index"]
        N, R = self.num_entities, self.num_relations
        edge_mask, self_mask = self._edge_masks(ctx, edge_index.shape[1], x,
                                                graph.get("edge_orig"))
        # per-(relation, aggregation node) mean normalization through the
        # host-built dense group ids
        groups = graph["rgcn_groups_vert"]
        counts = segment_sum(edge_mask, groups, graph["rgcn_num_groups_vert"])
        pos, valid = _bucket_edges(graph)
        rels = graph["rel_bucket_ids"]
        src, nbr = edge_index[0][pos], edge_index[1][pos]
        mask = valid.to(x.dtype) * edge_mask[pos]
        vals = mask / torch.clamp(counts[groups[pos]], min=1.0)
        h_j = rows(x, nbr)                               # [M, Emax, d]
        M, Emax = pos.shape
        if self.weight_decomposition == "block":
            nb = self.num_blocks_or_bases
            msg = torch.einsum(
                "mebi,mbio->mebo",
                h_j.reshape(M, Emax, nb, self.in_dim // nb),
                rows(self.blocks, rels),
            ).reshape(M, Emax, self.out_dim)
            self_w = self.block_self
        elif self.weight_decomposition == "basis":
            msg = torch.bmm(h_j, torch.einsum("mb,bio->mio",
                                              rows(self.comps, rels),
                                              self.bases))
            self_w = torch.einsum("b,bio->io", self.comps[R - 1], self.bases)
        else:
            msg = torch.bmm(h_j, rows(self.weights, rels))
            self_w = self.weights[R - 1]
        msg = msg * vals[..., None]
        out = segment_sum(msg.reshape(M * Emax, self.out_dim),
                          src.reshape(-1), N)
        # self edges (relation R - 1): one per node
        self_vals = self_mask / torch.clamp(self_mask, min=1.0)
        out = out + (x @ self_w) * self_vals[:, None]
        if self.bias_:
            out = out + self.bias
        return out, r


class WeightedGCNLayer(RgnnLayerBase):
    """W-GCN layer: alpha_r-weighted symmetric adjacency, one shared
    weight (reference: rgnn_encoder.py:908-998)."""

    def __init__(self, name, dataset, in_dim, out_dim, options,
                 **kwargs):
        super().__init__(name, dataset, in_dim, out_dim, options,
                         **kwargs)
        self.num_relations = dataset.num_relations() * 2 + 1
        self._init("weight", (in_dim, out_dim), self.weight_init)

        # the reference declares alpha as Embedding(..., padding_idx=0)
        # (rgnn_encoder.py:938): row 0 starts at zero and gets no gradient
        def alpha(g):
            a = init_weight(g, (self.num_relations + 1, 1), "normal_")
            a[0] = 0.0
            return a

        self._param("alpha", (self.num_relations + 1, 1), alpha)
        self._param("bn_scale", (out_dim,), lambda g: torch.ones(out_dim))
        self._param("bn_bias", (out_dim,), lambda g: torch.zeros(out_dim))
        if self.bias_:
            self._init("bias", (out_dim,), self.bias_init)

    def init_state(self):
        return self._bn_state()

    def forward(self, x, r, graph, ctx: Ctx):
        edge_index, edge_type = graph["edge_index"], graph["edge_type"]
        E = edge_index.shape[1]
        N = self.num_entities
        opts = dict(device=x.device, dtype=x.dtype)
        # the reference W-GCN layer has no edge dropout, only self-edge
        # dropout
        if ctx.train and self.self_edge_dropout > 0:
            self_mask = keep_mask(ctx, 1.0 - self.self_edge_dropout, (N,),
                                  **opts)
        else:
            self_mask = torch.ones(N, **opts)
        # the edges hold their inverse copies AND the reference
        # symmetrizes with A^T (rgnn_encoder.py:957-958): both passes below
        loop = torch.arange(N, device=x.device)
        src = torch.cat([edge_index[0], loop])
        dst = torch.cat([edge_index[1], loop])
        types = torch.cat([edge_type, torch.full(
            (N,), self.num_relations - 1, device=x.device,
            dtype=edge_type.dtype)])
        mask = torch.cat([torch.ones(E, **opts), self_mask])
        # padding_idx=0: row 0 multiplied by zero, in value and gradient
        row_keep = torch.ones_like(self.alpha)
        row_keep[0] = 0.0
        alpha = rows(self.alpha * row_keep, types)[:, 0] * mask
        xw = x @ self.weight
        out = segment_sum(rows(xw, dst) * alpha[:, None], src, N)
        out = out + segment_sum(rows(xw, src) * alpha[:, None], dst, N)
        if self.bias_:
            out = out + self.bias
        out = batch_norm_affine(out, self, f"{self.name}_bn", ctx)
        return out, r
