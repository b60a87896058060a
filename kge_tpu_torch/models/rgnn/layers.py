"""Relational GNN layers (counterpart of ``kge_tpu/models/rgnn/layers.py``;
reference: kge/model/embedder/rgnn_encoder.py).

Three layer families, each an ``nn.Module`` whose parameters carry the
names of ``kge_tpu``'s params dict (``w_in_h0``, ``loop_rel``, ...):

- ``MessagePassingLayer`` (CompGCN/RAGAT): gather neighbor and relation
  embeddings, compose, transform with a per-mode weight, and
  ``segment_sum`` back to the nodes. Edge and self-edge dropout are 0/1
  edge masks folded into the messages. Two routes move work off the
  edges, each where the algebra allows it:

  - ``hoistable``: linear compositions (``neighbor``, ``sub``) without a
    message weight transform the [N, d] table once and gather after;
  - ``spectral``: ``ccorr`` and ``ccorr_true`` without a message weight,
    attention or learned relation weight, under ``single``,
    ``single_with_self_edge_weight`` or ``direction`` propagation, on
    float32 tables. ccorr is a product of spectra bin by bin and the
    inverse FFT, the mode weight and the edge scale are linear, so the
    FFTs run once on the node and relation tables (the first mode's
    ``train.encode.messages``), each edge mode sums its products by node
    in the spectral domain (``ops/ccorr_reduce.py``: the kernel
    ``csrc/ccorr_reduce.cu`` on a card, over the orders the encoder
    builds with the graph, ``graph["spectral"]``), and the inverse FFT
    and the weight run once on the node sums (both in
    ``train.encode.aggregate``); the self-loop mode is node work on the
    same spectra. The same sums as the per-edge route in another order.

  Per-relation weights (basis/block decompositions) run
  as one batched gather, one ``einsum``/``bmm`` over the padded relation
  buckets and one ``index_add_`` (``kge_tpu`` scans the buckets one by
  one: the same sum in another order).
- ``RgcnLayer`` (torch-rgcn): sum_r A_r X W_r with per-(relation, node)
  mean normalization, batched over the buckets in the same way.
- ``WeightedGCNLayer`` (W-GCN/SACN): the per-relation scalar alpha
  collapses the relational adjacency to one symmetric matrix.

The layers aggregate over the edge list, which gives the numbers of
``kge_tpu``'s message path (and of its padded-CSR row blocks up to
summation order; row blocks are not ported). Two of ``kge_tpu``'s
layouts are:

- the dense adjacency (``tpu.gnn_dense_adjacency``): a hoistable mode's
  aggregation as one ``[N, N] @ [N, d]`` product against a per-graph
  matrix with the degree norm in it (``graph["dense_<key>"]``, built by
  the encoder), ``sub``'s relation term as ``C @ (r @ W)``
  (``_dense_aggregate``);
- under a device mesh with a ``model`` axis above 1, the halo route
  (``_halo_forward``, after ``kge_tpu``'s ``_halo_rowblock`` and
  ``_halo_attention``): the layer runs on this rank's row block of the
  nodes and the block's edges (``graph["halo"]``, built by the
  encoder); a hoistable mode exchanges the boundary rows of ``x @ W``,
  attention the raw ``x`` once an edge set for all heads, each in one
  ``all_to_all`` (``halo_exchange``). Edge masks, degree norms and
  dropout masks are drawn and computed over the whole graph from the
  generator every rank shares, then taken at the block's rows and
  edges, so a mesh step computes one process's. Every other layer takes
  the gathered route: the whole tables on every rank, the layer as on
  one process.

Batch-norm running statistics are model state, read from ``Ctx.state``
and written to ``Ctx.updates`` under ``f"{name}_bn"``; on the halo route
they are the sums over the model group of the blocks' real rows.

In training (``ctx.train``) a message-passing layer's forward names its
two phases for a profile (``train_span``): ``train.encode.messages``
around each mode's per-edge messages (gathers, composition, the message
transform, the edge scale; on the spectral route the tables' spectra and
the self-loop mode) and ``train.encode.aggregate`` around each route's
reduce by node (``segment_sum``, the dense adjacency's product, the
attention's edge softmax, the spectral reduce with its inverse FFT and
weight). The halo route and the R-GCN and W-GCN layers open none.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from kge_tpu_torch.models.api import Ctx
from kge_tpu_torch.models.init import initialize
from kge_tpu_torch.parallel.collectives import (
    data_sum, enter_blocks, halo_exchange,
)
from kge_tpu_torch.ops.ccorr_reduce import (
    CcorrReduce,
    from_spectra,
    loop_spectra,
    spectra,
    spectrum_bins,
)
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


def batch_norm_affine(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, state_key: str, ctx: Ctx,
                      block: Optional[Dict[str, Any]] = None,
                      momentum: float = 0.1, eps: float = 1e-5
                      ) -> torch.Tensor:
    """BatchNorm1d over the nodes with torch semantics (the biased
    variance normalizes, the unbiased one goes into the running
    statistics, momentum 0.1), then ``* scale + bias``. With ``block``
    (the halo route's ``graph["halo"]``) ``x`` is this rank's row block
    and the statistics are the sums over the model group of the blocks'
    real rows (padding rows left out, ``valid``)."""
    state = ctx.state[state_key]
    if ctx.train:
        if block is None:
            n = x.shape[0]
            mean = torch.mean(x, dim=0)
            var = torch.var(x, dim=0, correction=0)
        else:
            n, group = block["num_nodes"], block["group"]
            valid = block["valid"][:, None]
            mean = data_sum(torch.sum(x * valid, dim=0), group) / n
            var = data_sum(torch.sum(((x - mean) * valid) ** 2, dim=0),
                           group) / n
        unbiased = var.detach() * n / max(n - 1, 1)
        ctx.updates[state_key] = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


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


def train_span(ctx: Ctx, name: str):
    """A ``record_function`` span ``name`` in training, none otherwise;
    without a profiler it costs its enter and exit calls."""
    return record_function(name) if ctx.train else contextlib.nullcontext()


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
        # ccorr is a product of spectra bin by bin, and the inverse FFT,
        # the mode weight and the edge scale are linear: the FFTs run once
        # on the [N, d] and [R, d] tables, the per-edge product is summed
        # by node in the spectral domain, and the inverse FFT and the
        # matmul run once on the [N, K] sums (float32 tables only)
        self.spectral = (
            composition in ("ccorr", "ccorr_true")
            and not self.attention
            and not self.learned_relation_weight
            and self.propagation in ("single", "single_with_self_edge_weight",
                                     "direction")
        )
        if self.spectral:
            self.spectrum_bins = spectrum_bins(composition, in_dim)
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
                       head: int, is_loop: bool,
                       params=None) -> torch.Tensor:
        """Per-edge messages: compose, transform, weight, scale (the edge
        norm or the keep-mask). ``params``: the layer's parameters by
        name (the halo route passes them through ``enter_blocks``)."""
        p = self._parameters if params is None else params
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
            mw = (rows(p[f"w_msgweight_h{head}"], types)
                  if self.message_weight else None)
            msg = self.composition(None, h_j, rows(r_full, types), mw) @ weight
        if self.learned_relation_weight and not is_loop:
            msg = msg * rows(p["alpha"], types)
        return msg * scale[:, None]

    def rb_key(self, mode: str) -> Optional[str]:
        """``kge_tpu``'s name of a mode's edge set (its row blocks, dense
        adjacency and halo layout): ``in``/``out``, ``single`` (all
        edges) or ``single_with_loops`` (all edges and the self-loops);
        None for the self-loop mode and per-relation propagation."""
        if mode in ("in", "out"):
            return mode
        if mode != "":
            return None
        return "single" if self.self_edge_weight else "single_with_loops"

    def _mode_edges(self, mode, graph, edge_mask, self_mask):
        """(src, nbr, types, mask, is_loop) of a mode's whole edge set."""
        edge_index, edge_type = graph["edge_index"], graph["edge_type"]
        E, N = edge_index.shape[1], self.num_entities
        if mode in ("in", "out"):
            sl = slice(0, E // 2) if mode == "in" else slice(E // 2, E)
            return (edge_index[0, sl], edge_index[1, sl], edge_type[sl],
                    edge_mask[sl], False)
        loop_idx = torch.arange(N, device=edge_index.device)
        loop_types = torch.full((N,), self.num_relations,
                                device=edge_index.device,
                                dtype=edge_type.dtype)
        if mode == "loop":
            return loop_idx, loop_idx, loop_types, self_mask, True
        # "": all edges; without a self-edge weight the loops ride along
        if not self.self_edge_weight:
            return (torch.cat([edge_index[0], loop_idx]),
                    torch.cat([edge_index[1], loop_idx]),
                    torch.cat([edge_type, loop_types]),
                    torch.cat([edge_mask, self_mask]), False)
        return edge_index[0], edge_index[1], edge_type, edge_mask, False

    def _dense_aggregate(self, A, x, r_full, src, types, scale,
                         weight) -> torch.Tensor:
        """A hoistable mode's aggregation through its dense adjacency
        ``A`` (the degree norm in it): ``A @ (x @ W)``, less ``sub``'s
        relation term ``C @ (r @ W)`` with ``C[v, t]`` the summed scale
        of ``v``'s edges of type ``t`` (``kge_tpu``'s
        ``_row_block_aggregate`` dense path)."""
        out = DenseAdjacencyMatmul.apply(A, x @ weight)
        if self.composition_name == "sub":
            N, R1 = self.num_entities, r_full.shape[0]
            C = segment_sum(scale, src * R1 + types, N * R1).reshape(N, R1)
            out = out - C @ (r_full @ weight)
        return out

    def _per_relation_out(self, x, r_full, graph, edge_mask,
                          ctx: Ctx) -> torch.Tensor:
        """Every relation's messages with its own weight, batched over the
        padded relation buckets: one gather, one einsum/bmm, one
        index_add_."""
        N = self.num_entities
        with train_span(ctx, "train.encode.messages"):
            msg, src = self._per_relation_messages(x, r_full, graph,
                                                   edge_mask, ctx)
        with train_span(ctx, "train.encode.aggregate"):
            return segment_sum(msg.reshape(-1, self.out_dim),
                               src.reshape(-1), N)

    def _per_relation_messages(self, x, r_full, graph, edge_mask,
                               ctx: Ctx):
        """(messages [M, Emax, d_out], aggregation nodes [M, Emax]) over
        the padded relation buckets."""
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
        return msg, src

    def forward(self, x, r, graph, ctx: Ctx):
        if "halo" in graph:  # the encoder's route (``Rgnn.halo_route``)
            return self._halo_forward(x, r, graph, ctx)
        E = graph["edge_index"].shape[1]
        N = self.num_entities
        if self.weight_decomposition == "relation_basis":
            r = self.relation_basis_weights @ self.basis_vectors
        r_full = torch.cat([r, self.loop_rel], dim=0)
        edge_mask, self_mask = self._edge_masks(ctx, E, x,
                                                graph.get("edge_orig"))
        num_modes = len(self.modes)
        spectral = self.spectral and x.dtype == r_full.dtype == torch.float32
        tables = None  # the node and relation spectra, once a call
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
                src, nbr, types, mask, is_loop = self._mode_edges(
                    mode, graph, edge_mask, self_mask)
                scale = mask
                if self.use_edge_norm and not is_loop:
                    scale = degree_norm(src, nbr, mask, N)
                weight = getattr(self, f"w_{mode}_h{head}")
                dense = graph.get(f"dense_{self.rb_key(mode)}")
                if dense is not None and self.hoistable and not self.attention:
                    with train_span(ctx, "train.encode.aggregate"):
                        agg = self._dense_aggregate(dense, x, r_full, src,
                                                    types, scale, weight)
                elif spectral:
                    with train_span(ctx, "train.encode.messages"):
                        if tables is None:
                            tables = (spectra(x, self.spectrum_bins),
                                      spectra(r_full, self.spectrum_bins))
                        if is_loop:
                            agg = self._from_spectra(
                                loop_spectra(tables[0], tables[1][-1], scale),
                                weight)
                    if not is_loop:
                        with train_span(ctx, "train.encode.aggregate"):
                            agg = self._from_spectra(CcorrReduce.apply(
                                *tables, scale,
                                graph["spectral"][self.rb_key(mode)]), weight)
                else:
                    with train_span(ctx, "train.encode.messages"):
                        msg = self._edge_messages(x, r_full, nbr, types,
                                                  scale, weight, head,
                                                  is_loop)
                    if self.attention:
                        per_mode.append((msg, src, mask))
                        continue
                    agg = msg
                    if not is_loop:
                        with train_span(ctx, "train.encode.aggregate"):
                            agg = segment_sum(msg, src, N)
                if not is_loop:
                    agg = ctx.dropout(agg, self.prop_dropout, replicated=True)
                if self.propagation == "direction":
                    agg = agg / num_modes
                per_mode.append(agg)
            if self.attention:
                # RAGAT: an edge softmax per target node
                with train_span(ctx, "train.encode.aggregate"):
                    head_outputs.append(self._attention(
                        per_mode, getattr(self, f"w_att_h{head}"), N,
                        lambda e: ctx.dropout(e, self.prop_dropout,
                                              replicated=True)))
            else:
                head_outputs.append(sum(per_mode[1:], per_mode[0]))
        return self._finish(head_outputs, r_full, ctx, self._parameters)

    def _from_spectra(self, sums, weight) -> torch.Tensor:
        """The spectral route's messages summed by node: the inverse FFT
        of the spectral sums [N, Kp, 2], then the mode weight."""
        return from_spectra(sums, self.spectrum_bins, self.in_dim) @ weight

    def _attention(self, per_mode, att_w, num_nodes, dropout):
        """The edge softmax over the modes' (messages, target nodes,
        masks): ``dropout`` falls on the numerator only."""
        messages = torch.cat([m for m, _, _ in per_mode])
        dst = torch.cat([s for _, s, _ in per_mode])
        emask = torch.cat([m for _, _, m in per_mode])
        scores = -F.leaky_relu((messages @ att_w).reshape(-1),
                               negative_slope=0.2)
        # dropped edges leave the softmax entirely (the reference removes
        # them from edge_index): no exp(0) in the denominator
        edge_exp = (torch.exp(scores) * (emask > 0))[:, None]
        entity_exp = segment_sum(edge_exp, dst, num_nodes)
        entity_exp = torch.where(entity_exp == 0.0, 1.0, entity_exp)
        weighted = segment_sum(dropout(edge_exp) * messages, dst, num_nodes)
        return weighted / entity_exp

    def _finish(self, head_outputs, r_full, ctx: Ctx, params,
                block: Optional[Dict[str, Any]] = None):
        """Heads averaged (attention) or summed, bias, batch norm; the
        relation transform (which drops the loop relation row)."""
        out = (head_outputs[0] / self.num_heads if self.attention
               else head_outputs[0])
        for h in head_outputs[1:]:
            out = out + h / self.num_heads
        if self.bias_:
            out = out + params["bias"]
        if not self.propagation.startswith("per_relation"):
            out = batch_norm_affine(out, params["bn_scale"],
                                    params["bn_bias"], f"{self.name}_bn",
                                    ctx, block)
        if block is not None:
            out = out * block["valid"][:, None]
        if self.rel_transformation == "self":
            rel = r_full[:-1]
        elif self.rel_transformation == "linear":
            rel = (r_full @ self.w_rel)[:-1]
        else:
            raise NotImplementedError(
                f"rel_transformation {self.rel_transformation}"
            )
        return out, rel

    #: parameters read by the relation transform alone (replicated)
    _RELATION_PARAMS = ("loop_rel", "w_rel", "basis_vectors",
                        "relation_basis_weights")

    def _halo_forward(self, x, r, graph, ctx: Ctx):
        """The layer on this rank's row block ``x`` ([S, d]) of the nodes
        and the block's edges (``graph["halo"]``): one process's numbers
        at the block's rows, the boundary rows of the other blocks by
        ``halo_exchange``. Masks and degree norms come from the whole
        graph; the weights and relations enter through ``enter_blocks``
        (each rank's gradient covers its rows)."""
        halo = graph["halo"]
        group, S, N = halo["group"], halo["S"], self.num_entities
        E = graph["edge_index"].shape[1]
        if self.weight_decomposition == "relation_basis":
            r = self.relation_basis_weights @ self.basis_vectors
        r_full = torch.cat([r, self.loop_rel], dim=0)
        edge_mask, self_mask = self._edge_masks(ctx, E, x,
                                                graph.get("edge_orig"))
        names = [n for n in self._parameters
                 if n not in self._RELATION_PARAMS]
        entered = enter_blocks(
            [r_full] + [self._parameters[n] for n in names], group)
        rb, p = entered[0], dict(zip(names, entered[1:]))
        block_rows, valid = halo["rows"], halo["valid"]
        block_ids = torch.arange(S, device=x.device)
        loop_types = torch.full((S,), rb.shape[0] - 1, device=x.device,
                                dtype=graph["edge_type"].dtype)
        self_block = self_mask[block_rows] * valid
        num_modes = len(self.modes)
        tables: Dict[str, torch.Tensor] = {}  # raw x a key, all heads
        head_outputs = []
        for head in range(self.num_heads):
            per_mode, positions, offset = [], [], 0
            for mode in self.modes:
                weight = p[f"w_{mode}_h{head}"]
                key = self.rb_key(mode)
                if key is None:  # the block's self-loops
                    dst, slot, types, scale = (block_ids, block_ids,
                                               loop_types, self_block)
                    total, where = N, block_rows
                else:
                    src, nbr, types, mask, _ = self._mode_edges(
                        mode, graph, edge_mask, self_mask)
                    if self.use_edge_norm:
                        mask = degree_norm(src, nbr, mask, N)
                    pos = halo["pos"][key]
                    dst, slot = halo["src"][key], halo["slot"][key]
                    types, scale = types[pos], mask[pos]
                    total, where = src.shape[0], pos
                if self.attention:
                    tab = x
                    if key is not None:
                        if key not in tables:
                            tables[key] = torch.cat([x, halo_exchange(
                                x, halo["send"][key], group)])
                        tab = tables[key]
                    msg = self._edge_messages(tab, rb, slot, types, scale,
                                              weight, head, key is None, p)
                    per_mode.append((msg, dst, scale))
                    positions.append(offset + where)
                    offset += total
                    continue
                xw = x @ weight
                if key is None:
                    msg = xw
                    if self.composition_name == "sub":
                        msg = msg - (rb[-1] @ weight)[None, :]
                    agg = msg * scale[:, None]
                else:
                    tab = torch.cat([xw, halo_exchange(
                        xw, halo["send"][key], group)])
                    msg = rows(tab, slot)
                    if self.composition_name == "sub":
                        msg = msg - rows(rb @ weight, types)
                    if self.learned_relation_weight:
                        msg = msg * rows(p["alpha"], types)
                    agg = segment_sum(msg * scale[:, None], dst, S)
                    agg = ctx.dropout_at(agg, self.prop_dropout, N,
                                         block_rows)
                if self.propagation == "direction":
                    agg = agg / num_modes
                per_mode.append(agg)
            if self.attention:
                where = torch.cat(positions)
                head_outputs.append(self._attention(
                    per_mode, p[f"w_att_h{head}"], S,
                    lambda e: ctx.dropout_at(e, self.prop_dropout, offset,
                                             where)))
            else:
                head_outputs.append(sum(per_mode[1:], per_mode[0]))
        return self._finish(head_outputs, r_full, ctx, p, halo)


class DenseAdjacencyMatmul(torch.autograd.Function):
    """``A.float() @ xw`` in row chunks of ``A`` (a bf16 ``A`` is never
    upcast whole); backward ``A.T @ g`` likewise. ``A`` is a constant."""

    @staticmethod
    def forward(ctx, A, xw):
        ctx.save_for_backward(A)
        step = max(1, (1 << 26) // max(A.shape[1], 1))
        return torch.cat([A[i:i + step].float() @ xw
                          for i in range(0, A.shape[0], step)])

    @staticmethod
    def backward(ctx, grad):
        (A,) = ctx.saved_tensors
        step = max(1, (1 << 26) // max(A.shape[1], 1))
        out = None
        for i in range(0, A.shape[0], step):
            part = A[i:i + step].float().T @ grad[i:i + step]
            out = part if out is None else out + part
        return None, out



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
        out = batch_norm_affine(out, self.bn_scale, self.bn_bias,
                                f"{self.name}_bn", ctx)
        return out, r
