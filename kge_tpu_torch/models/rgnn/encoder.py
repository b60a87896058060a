"""R-GNN encoder stack and encoder-decoder model (counterpart of
``kge_tpu/models/rgnn/encoder.py``; reference:
kge/model/embedder/rgnn_encoder.py:1002-1328 and
kge/model/kge_model.py:774-1066).

The encoder runs the GNN over the whole training graph, and the decoder
scorer reads the contextualized embeddings. The graph is built on the
host (``build_graph_buffers``, rebuilt on per-epoch graph sampling) and
kept on the model's device. ``use_stale_embeddings`` (the reference's
cached forward with retained graphs, rgnn_encoder.py:1241-1267) is a
memo in ``Ctx.cache``: the encoder runs once a training step (or
subbatch) and once an evaluation batch, every score call of it reads
that output, and the backward of the summed loss flows through the one
encoder graph, as in ``kge_tpu``.

The params tree is ``kge_tpu``'s: ``{entity_embedder, relation_embedder,
scorer, encoder: {layers: [...]}}``; the batch-norm statistics of the
layers are model state under ``f"{layer name}_bn"``.

Under a device mesh (``tpu.mesh``) the model raises
``NotImplementedError``: ``kge_tpu``'s edge-partitioned halo exchange is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models.api import Ctx, KgeBase, KgeModel
from kge_tpu_torch.models.conve import ConvEScorer
from kge_tpu_torch.models.rgnn.layers import (
    MessagePassingLayer,
    RgcnLayer,
    WeightedGCNLayer,
)
from kge_tpu_torch.utils.misc import pow2_bucket

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    # jax.nn.gelu's default: the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


def build_graph_buffers(triples: np.ndarray, num_relations: int,
                        per_relation: bool,
                        num_entities: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Edge buffers (the inverse edges with offset relation ids) and, for
    per-relation layers, the padded relation buckets and the (relation,
    aggregation node) group ids (``kge_tpu``'s numpy path).

    Each half is stably sorted by its aggregation node (``edge_index[0]``);
    ``edge_orig`` maps each edge position to its triple, so edge dropout
    keeps a triple's two edges together. ``halves_sorted`` marks the sort
    (its presence is what ``kge_tpu`` reads)."""
    fwd = triples[:, [0, 2]].T.astype(np.int32)
    order_fwd = np.argsort(fwd[0], kind="stable")
    order_inv = np.argsort(fwd[1], kind="stable")
    E1 = fwd.shape[1]
    edge_index = np.empty((2, 2 * E1), np.int32)
    edge_index[0, :E1] = fwd[0][order_fwd]
    edge_index[1, :E1] = fwd[1][order_fwd]
    edge_index[0, E1:] = fwd[1][order_inv]
    edge_index[1, E1:] = fwd[0][order_inv]
    rels = np.ascontiguousarray(triples[:, 1]).astype(np.int32)
    edge_type = np.concatenate(
        [rels[order_fwd], rels[order_inv] + num_relations]
    ).astype(np.int32)
    graph: Dict[str, Any] = {
        "edge_index": edge_index,
        "edge_type": edge_type,
        "edge_orig": np.concatenate([order_fwd, order_inv]).astype(np.int32),
        "halves_sorted": np.zeros(0, np.int32),
    }
    E = edge_index.shape[1]
    if per_relation:
        rels, counts = np.unique(edge_type, return_counts=True)
        # each relation's edges in chunks of one width: padding stays
        # below one chunk a relation on skewed graphs
        emax = pow2_bucket(int(counts.max())) if len(counts) else 1
        emax = min(emax, 2048)
        if len(counts):
            budget = max(8, E // (2 * len(rels)))
            emax = min(emax, 1 << (budget.bit_length() - 1))
        rows: list = []
        row_rels: list = []
        order = np.argsort(edge_type, kind="stable")
        start = 0
        for rel, c in zip(rels, counts):
            edges = order[start : start + c]
            start += c
            for off in range(0, c, emax):
                chunk = edges[off : off + emax]
                row = np.full(emax, -1, dtype=np.int32)
                row[: len(chunk)] = chunk
                rows.append(row)
                row_rels.append(rel)
        graph["rel_buckets"] = (
            np.stack(rows) if rows else np.full((1, emax), -1, np.int32)
        )
        graph["rel_bucket_ids"] = np.asarray(row_rels or [0], dtype=np.int32)
        nodes = edge_index[0]
        enc = edge_type.astype(np.int64) * (int(nodes.max()) + 1 if
                                            len(nodes) else 1) + nodes
        uniq, inv = np.unique(enc, return_inverse=True)
        graph["rgcn_groups_vert"] = inv.astype(np.int32)
        graph["rgcn_num_groups_vert"] = int(len(uniq))
    return graph


class Rgnn(KgeBase):
    """Stack of R-GNN layers (reference: rgnn_encoder.py:1002-1205)."""

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key: str, dim: int, **kwargs):
        super().__init__(config, dataset, configuration_key)
        num_layers = self.get_option("num_layers")
        act_key = self.get_option("activation")
        if act_key not in _ACTIVATIONS:
            raise ValueError(f"invalid activation {act_key}")
        self.activation = _ACTIVATIONS[act_key]
        self.emb_entity_dropout = self.get_option("emb_entity_dropout")
        self.layer_type = self.check_option(
            "layer_type", ["message_passing", "torch_rgcn", "weighted_gcn"]
        )
        options = {
            "weight_init": self.get_option("weight_init"),
            "bias": self.get_option("bias"),
            "bias_init": self.get_option("bias_init"),
            "edge_dropout": self.get_option("edge_dropout"),
            "self_edge_dropout": self.get_option("self_edge_dropout"),
            "rel_transformation": self.get_option("rel_transformation"),
            "weight_decomposition": str(self.get_option(
                "weight_decomposition")),
            "num_blocks_or_bases": self.get_option("num_blocks_or_bases"),
            "message_passing_args": {
                key: self.get_option(f"message_passing_args.{key}")
                for key in ("propagation", "composition", "message_weight",
                            "learned_relation_weight", "edge_norm",
                            "emb_propagation_dropout", "attention",
                            "num_heads")
            },
        }
        layers = []
        in_dim = dim
        for i in range(num_layers):
            try:
                out_dim = self.get_option(f"{i + 1}_out_dim")
                if out_dim < 0:
                    out_dim = in_dim
            except KeyError:
                out_dim = in_dim
            name = f"{configuration_key}.layer{i}"
            if self.layer_type == "message_passing":
                layer = MessagePassingLayer(
                    name, dataset, in_dim, out_dim, options,
                    first_layer=(i == 0), **kwargs)
            elif self.layer_type == "torch_rgcn":
                layer = RgcnLayer(name, dataset, in_dim, out_dim, options,
                                  **kwargs)
            else:
                layer = WeightedGCNLayer(name, dataset, in_dim, out_dim,
                                         options, **kwargs)
            layers.append(layer)
            in_dim = out_dim
        self.layers = nn.ModuleList(layers)

    @property
    def needs_rel_buckets(self) -> bool:
        return self.layer_type == "torch_rgcn" or any(
            isinstance(l, MessagePassingLayer)
            and l.propagation.startswith("per_relation")
            for l in self.layers
        )

    def check_tpu_layouts(self):
        """``kge_tpu``'s TPU-only aggregation layouts: their knobs are
        logged as ignored (the edge-list aggregation gives the same
        numbers up to summation order), the bf16 dense adjacency raises
        (it changes the numbers), and ``always`` raises where
        ``kge_tpu`` finds the dense adjacency inapplicable."""
        config = self.config
        try:
            block = int(self.get_option("neighbor_block_size"))
        except KeyError:
            block = 0
        if block > 0:
            config.log(
                f"{self.configuration_key}.neighbor_block_size {block} is "
                "ignored: kge_tpu_torch aggregates over the edge list "
                "(gather + index_add_); kge_tpu's row blocks give the same "
                "numbers up to summation order")
        mode = config.check("tpu.gnn_dense_adjacency",
                            ["auto", "always", "never"])
        dtype = config.check("tpu.gnn_dense_adjacency_dtype",
                             ["float32", "bfloat16"])
        if mode != "always":
            if mode == "auto" and dtype != "float32":
                config.log(f"tpu.gnn_dense_adjacency_dtype {dtype} is "
                           "ignored under auto (kge_tpu engages it on a TPU "
                           "only)")
            return
        reasons = []
        for l in self.layers:
            if not isinstance(l, MessagePassingLayer):
                reasons.append(f"{l.name}: not a message-passing layer")
                continue
            if l.propagation.startswith("per_relation"):
                reasons.append(f"{l.name}: per_relation propagation")
            if not l.hoistable:
                reasons.append(
                    f"{l.name}: composition {l.composition_name!r} does "
                    "not commute with the mode weight")
            if l.attention:
                reasons.append(f"{l.name}: attention softmax is per-edge")
            if l.learned_relation_weight:
                reasons.append(f"{l.name}: learned relation weight is a "
                               "per-edge parameter")
            if l.edge_dropout > 0 or l.self_edge_dropout > 0:
                reasons.append(f"{l.name}: edge dropout makes the scale "
                               "per-step")
            if l.composition_name == "sub":
                R1 = l.num_relations + 1
                if l.num_entities * R1 > 64 * 1024 * 1024:
                    reasons.append(
                        f"{l.name}: 'sub' needs the C-matrix relation "
                        f"term, too large at N*R = {l.num_entities * R1}")
        if reasons:
            raise ValueError(
                "tpu.gnn_dense_adjacency=always is not applicable here: "
                + "; ".join(reasons))
        if dtype != "float32":
            raise NotImplementedError(
                "tpu.gnn_dense_adjacency with bfloat16 is not yet ported to "
                "kge_tpu_torch (it changes the numbers; bf16 compute comes "
                "with tpu.compute_dtype)")
        config.log(
            "tpu.gnn_dense_adjacency always is ignored: kge_tpu_torch "
            "aggregates over the edge list, which gives the float32 dense "
            "adjacency's numbers up to summation order")

    def init_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for l in self.layers:
            state.update(l.init_state())
        return state

    def forward(self, x, r, graph, ctx: Ctx):
        # bf16 embeddings (tpu.compute_dtype) meet every layer's float32
        # weights first, a product jnp promotes: the layers run in float32
        x, r = (t.float() if t.dtype == torch.bfloat16 else t for t in (x, r))
        for layer in self.layers:
            if self.layer_type == "torch_rgcn":
                x = self.activation(x)  # rgcn activates before the layer
            x, r = layer(x, r, graph, ctx)
            if self.layer_type in ("message_passing", "weighted_gcn"):
                x = self.activation(x)
            x = ctx.dropout(x, self.emb_entity_dropout)
        return x, r


class RgnnEncoder(KgeBase):
    """Runs the GNN over the whole graph (reference:
    rgnn_encoder.py:1208-1328). Its only children are the layers, so its
    ``state_dict`` is the ``encoder`` subtree of ``kge_tpu``'s params;
    the embedders it reads are the model's."""

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key: str, entity_embedder, relation_embedder,
                 reciprocal_scorer: bool = False, *, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key)
        # outside the module tree: the model holds them
        self.__dict__["entity_embedder"] = entity_embedder
        self.__dict__["relation_embedder"] = relation_embedder
        self.reciprocal_scorer = reciprocal_scorer
        rgnn = Rgnn(config, dataset, configuration_key, entity_embedder.dim,
                    device=device, generator=generator,
                    init_for_load_only=init_for_load_only)
        self.__dict__["rgnn"] = rgnn
        self.layers = rgnn.layers
        rgnn.check_tpu_layouts()
        self.use_stale_embeddings = self.get_option("use_stale_embeddings")
        self.device = torch.device(device)
        self._graph: Dict[str, Any] = {}
        self.set_graph(None)

    def set_graph(self, triples: Optional[np.ndarray]):
        """(Re)build the edge buffers on the device; None means the full
        training split."""
        if triples is None:
            triples = self.dataset.split(self.config.get("train.split"))
        graph = build_graph_buffers(
            np.asarray(triples), self.dataset.num_relations(),
            self.rgnn.needs_rel_buckets,
            num_entities=self.dataset.num_entities(),
        )
        # int64 index tensors: every indexing op takes them as they are
        self._graph = {
            k: v if isinstance(v, int) else torch.as_tensor(
                v.astype(np.int64), device=self.device)
            for k, v in graph.items()
        }

    def graph(self) -> Dict[str, Any]:
        return self._graph

    def init_state(self):
        return self.rgnn.init_state()

    def encode(self, ctx: Ctx) -> Tuple[torch.Tensor, torch.Tensor]:
        """All contextualized entity and relation embeddings. With stale
        embeddings the forward is shared by every score call of the Ctx
        (``Ctx.cache``)."""
        cache_key = f"{self.configuration_key}.encoded"
        if self.use_stale_embeddings and cache_key in ctx.cache:
            return ctx.cache[cache_key]
        x = self.entity_embedder.embed_all(ctx)
        r = self.relation_embedder.embed_all(ctx)
        x, r = self.rgnn(x, r, self._graph, ctx)
        if not self.reciprocal_scorer:
            r = r[: self.dataset.num_relations()]
        ctx.cache[cache_key] = (x, r)
        return x, r


class KgeRgnnModel(KgeModel):
    """Encoder-decoder composition: embedders -> R-GNN -> decoder scorer
    (reference: kge/model/kge_model.py:774-1066). Its children are the
    embedders, the decoder's scorer and the encoder; the decoder model
    itself stays outside the module tree (its own embedders are unused,
    as in ``kge_tpu``)."""

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key=None, *, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        self._init_configuration(config, configuration_key)
        from kge_tpu_torch.parallel import mesh as mesh_lib

        if mesh_lib.active() is not None:
            raise NotImplementedError(
                "R-GNN encoders under a device mesh (tpu.mesh) are not yet "
                "ported to kge_tpu_torch: kge_tpu's edge-partitioned halo "
                "exchange (kge_tpu/models/rgnn/layers.py _halo_rowblock, "
                "encoder.py edge-partitioned layout) comes in a later slice")
        self.orig_num_relations = dataset.num_relations()
        # embedders over the doubled relation vocabulary (inverse edges)
        alt_dataset = dataset.shallow_copy()
        alt_dataset._num_relations = self.orig_num_relations * 2
        alt_dataset._meta = dict(dataset._meta)
        try:
            rel_ids = list(dataset.relation_ids())
            alt_dataset._meta["relation_ids"] = rel_ids + [
                f"{r}_reciprocal" for r in rel_ids
            ]
        except (KeyError, OSError, TypeError):
            pass  # no relation id map (as kge_tpu, go on without names)
        kwargs = dict(device=device, generator=generator,
                      init_for_load_only=init_for_load_only)
        super().__init__(config, alt_dataset, None,
                         configuration_key=self.configuration_key, **kwargs)
        key = self.configuration_key
        self.reciprocal_scorer = (
            config.get(key + ".decoder.model") == "reciprocal_relations_model")
        decoder = KgeModel.create(config, dataset,
                                  configuration_key=key + ".decoder", **kwargs)
        self.__dict__["_decoder"] = decoder
        self.scorer = decoder.get_scorer()
        if isinstance(self.scorer, ConvEScorer):
            # the GNN's last layer emits ConvE-sized entity embeddings
            num_layers = config.get(key + ".encoder.num_layers")
            config.set(f"{key}.encoder.{num_layers}_out_dim",
                       decoder.get_s_embedder().dim, create=True)
            if config.get(key + ".encoder.rel_transformation") == "self":
                # untransformed relations must already be ConvE-sized
                self.relation_embedder = decoder.get_p_embedder()
        self.encoder = RgnnEncoder(
            config, dataset, key + ".encoder", self.entity_embedder,
            self.relation_embedder, reciprocal_scorer=self.reciprocal_scorer,
            **kwargs)
        self.model_state = self.init_state()

    def init_state(self):
        if "encoder" not in self._modules:  # KgeModel.__init__, too early
            return {}
        return {**self.scorer.init_state(), **self.encoder.init_state()}

    def supports_dot_ranking(self) -> bool:
        # a dot form would bypass the encoder: the generic route
        return False

    def set_graph(self, triples):
        self.encoder.set_graph(triples)

    # ------------------------------------------------------------------ scoring

    def _encode(self, ctx: Ctx):
        return self.encoder.encode(ctx)

    def score_spo(self, s, p, o, direction=None, ctx=None):
        ctx = ctx or self.default_ctx()
        if self.reciprocal_scorer:
            # as kge_tpu: the s direction scores (s, p + R, o), s and o
            # not swapped
            if direction == "s":
                p = p + self.orig_num_relations
            elif direction != "o":
                raise ValueError(
                    "reciprocal decoders cannot score undirected spo"
                )
        x, r = self._encode(ctx)
        return self.scorer.score_emb_spo(x[s], r[p], x[o], ctx)

    def score_sp(self, s, p, o_subset=None, ctx=None):
        ctx = ctx or self.default_ctx()
        x, r = self._encode(ctx)
        o_emb = x if o_subset is None else x[o_subset]
        return self.scorer.score_emb(x[s], r[p], o_emb, "sp_", ctx)

    def score_po(self, p, o, s_subset=None, ctx=None):
        ctx = ctx or self.default_ctx()
        x, r = self._encode(ctx)
        s_emb = x if s_subset is None else x[s_subset]
        if self.reciprocal_scorer:
            return self.scorer.score_emb(
                x[o], r[p + self.orig_num_relations], s_emb, "sp_", ctx)
        return self.scorer.score_emb(s_emb, r[p], x[o], "_po", ctx)

    def score_so(self, s, o, p_subset=None, ctx=None):
        if self.reciprocal_scorer:
            raise ValueError("reciprocal decoders cannot score relations")
        ctx = ctx or self.default_ctx()
        x, r = self._encode(ctx)
        p_emb = r if p_subset is None else r[p_subset]
        return self.scorer.score_emb(x[s], p_emb, x[o], "s_o", ctx)

    def score_sp_po(self, s, p, o, entity_subset=None, ctx=None):
        ctx = ctx or self.default_ctx()
        x, r = self._encode(ctx)
        s_emb, o_emb, p_emb = x[s], x[o], r[p]
        ents = x if entity_subset is None else x[entity_subset]
        if self.reciprocal_scorer:
            p_inv = r[p + self.orig_num_relations]
            sp = self.scorer.score_emb(s_emb, p_emb, ents, "sp_", ctx)
            po = self.scorer.score_emb(o_emb, p_inv, ents, "sp_", ctx)
        else:
            sp = self.scorer.score_emb(s_emb, p_emb, ents, "sp_", ctx)
            po = self.scorer.score_emb(ents, p_emb, o_emb, "_po", ctx)
        return torch.cat([sp, po], dim=1)


class RGCN(KgeRgnnModel):
    pass


class WGCN(KgeRgnnModel):
    pass


class CompGCN(KgeRgnnModel):
    pass


class RAGAT(KgeRgnnModel):
    pass
