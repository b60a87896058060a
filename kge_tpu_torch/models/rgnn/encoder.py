"""R-GNN encoder stack and encoder-decoder model (counterpart of
``kge_tpu/models/rgnn/encoder.py``; reference:
kge/model/embedder/rgnn_encoder.py:1002-1328 and
kge/model/kge_model.py:774-1066).

The encoder runs the GNN over the whole training graph, and the decoder
scorer reads the contextualized embeddings. The graph is built on the
host (``build_graph_buffers``, rebuilt on per-epoch graph sampling) and
kept on the model's device; for layers on the spectral route
(``MessagePassingLayer.spectral``) it holds the three orders of each of
their edge sets that the ccorr reduce reads (``spectral_orders``,
int32). ``use_stale_embeddings`` (the reference's
cached forward with retained graphs, rgnn_encoder.py:1241-1267) is a
memo in ``Ctx.cache``: the encoder runs once a training step (or
subbatch) and once an evaluation batch, every score call of it reads
that output, and the backward of the summed loss flows through the one
encoder graph, as in ``kge_tpu``.

The params tree is ``kge_tpu``'s: ``{entity_embedder, relation_embedder,
scorer, encoder: {layers: [...]}}``; the batch-norm statistics of the
layers are model state under ``f"{layer name}_bn"``.

Under a device mesh (``tpu.mesh``) with a ``model`` axis above 1 the
encoder takes ``kge_tpu``'s two routes (``prepare_job`` hands it the
mesh): hoistable or attention message-passing layers with
``neighbor_block_size > 0`` run on this rank's row block of the nodes
and exchange only the boundary rows (the halo route, whose layout
``build_halo_layout`` makes from the edge list, rebuilt with every
graph); every other encoder runs on the whole tables, gathered, on every
rank (the gathered route). The decoder reads the encoded entity table
through one gather of the last layer's output.

``tpu.gnn_dense_adjacency`` (``Rgnn.dense_adjacency_modes``,
``RgnnEncoder._maybe_build_dense``) keeps ``kge_tpu``'s rules: ``auto``
engages on the card within ``gnn_dense_adjacency_limit_bytes`` (never on
the host, never under a model axis above 1), ``always`` raises where the
adjacency does not apply, and the matrix is stored in float32 or bf16.

A training forward of the encoder is the ``record_function`` span
``train.encode`` (its layers name ``train.encode.messages`` and
``train.encode.aggregate`` inside it). While a profiler records, its
backward is the span ``train.encode.backward`` on autograd's thread
(``backward_span``): gradient hooks open it at the first gradient of the
encoder's outputs and close it once its inputs' gradients are complete.
Without a profiler, or while the current stream is capturing a CUDA
graph (a replay runs no Python), no hook is registered.

``graph_version`` counts the graphs the encoder has built: a trainer
that replays captured steps drops them when it changes (``set_graph``,
``prepare_job``'s halo rebuild), since a graph reads the tensors that
were bound when it was captured.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch import native
from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models.api import Ctx, KgeBase, KgeModel
from kge_tpu_torch.models.conve import ConvEScorer
from kge_tpu_torch.models.rgnn.layers import (
    MessagePassingLayer,
    RgcnLayer,
    WeightedGCNLayer,
    train_span,
)
from kge_tpu_torch.ops.ccorr_reduce import build_orders
from kge_tpu_torch.ops.segment import degree_norm
from kge_tpu_torch.parallel import distributed as dist
from kge_tpu_torch.parallel import mesh as mesh_lib
from kge_tpu_torch.parallel.collectives import gather_table
from kge_tpu_torch.utils.misc import pow2_bucket

#: above this many [N x R] elements ``sub``'s relation-term matrix is not
#: made, and the dense adjacency does not apply (``kge_tpu``'s bound)
C_MATRIX_MAX_ELEMENTS = 64 * 1024 * 1024

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
                        num_entities: Optional[int] = None,
                        spectral_sets: Tuple[str, ...] = ()
                        ) -> Dict[str, Any]:
    """Edge buffers (the inverse edges with offset relation ids) and, for
    per-relation layers, the padded relation buckets and the (relation,
    aggregation node) group ids (``kge_tpu``'s numpy path).

    Each half is stably sorted by its aggregation node (``edge_index[0]``);
    ``edge_orig`` maps each edge position to its triple, so edge dropout
    keeps a triple's two edges together. ``halves_sorted`` marks the sort
    (its presence is what ``kge_tpu`` reads); the sort is the g++ host
    op's stable counting sort (``native.counting_argsort``).
    ``spectral_sets`` names the edge sets (``mode_edge_set``) whose
    orders the spectral route reads (``graph["spectral"][key]``,
    ``spectral_orders``)."""
    fwd = triples[:, [0, 2]].T.astype(np.int32)
    buckets = num_entities if num_entities is not None else (
        int(fwd.max()) + 1 if fwd.size else 1)
    order_fwd = native.counting_argsort(fwd[0], buckets)
    order_inv = native.counting_argsort(fwd[1], buckets)
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
    if spectral_sets:
        graph["spectral"] = spectral_orders(graph, spectral_sets, buckets,
                                            num_relations)
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


def mode_edge_set(edge_index: np.ndarray, key: str, num_nodes: int):
    """(src, nbr) of an edge set by ``kge_tpu``'s name: ``in`` (the
    first half of the edges), ``out`` (the second), ``single`` (all) or
    ``single_with_loops`` (all, then a self-loop a node)."""
    E = edge_index.shape[1]
    if key == "in":
        return edge_index[0, :E // 2], edge_index[1, :E // 2]
    if key == "out":
        return edge_index[0, E // 2:], edge_index[1, E // 2:]
    if key == "single":
        return edge_index[0], edge_index[1]
    loop = np.arange(num_nodes, dtype=edge_index.dtype)
    return (np.concatenate([edge_index[0], loop]),
            np.concatenate([edge_index[1], loop]))


def spectral_orders(graph: Dict[str, Any], keys: Tuple[str, ...],
                    num_nodes: int, num_relations: int) -> Dict[str, Any]:
    """The spectral route's three orders (``ccorr_reduce.build_orders``)
    of each edge set in ``keys``, its relations as a layer's
    ``_mode_edges`` gives them: the self-loops' is the loop relation
    ``2 * num_relations``, the last row of the layer's relation table."""
    edge_type = graph["edge_type"]
    E = edge_type.shape[0]
    out = {}
    for key in keys:
        src, nbr = mode_edge_set(graph["edge_index"], key, num_nodes)
        types = {"in": edge_type[:E // 2], "out": edge_type[E // 2:],
                 "single": edge_type}.get(key)
        if types is None:  # single_with_loops
            types = np.concatenate([edge_type, np.full(
                num_nodes, 2 * num_relations, edge_type.dtype)])
        out[key] = build_orders(src, nbr, types, num_nodes,
                                2 * num_relations + 1)
    return out


def build_halo_layout(graph: Dict[str, Any], keys: Tuple[str, ...], P: int,
                      num_nodes_padded: int,
                      num_nodes: int) -> Dict[str, Any]:
    """The edge-partitioned layout of the mesh GNN on the edge list
    (``kge_tpu``'s ``build_halo_structures`` without its row blocks).

    Block p of ``P`` owns nodes ``[p*S, (p+1)*S)``, ``S =
    num_nodes_padded / P``, and the edges whose aggregation node it
    owns. For each edge set in ``keys``: ``send`` [P, P, rmax], the rows
    block q sends to block p (local ids on q, the unique remote
    neighbors of p's edges that q owns, ascending, padded with 0 to the
    widest set, rmax); for each block p, ``pos`` (its edges' positions
    in the edge set, in order), ``src`` (their aggregation nodes as
    local rows) and ``slot`` (their neighbors in p's gather table: a
    local row as it is, block q's i-th boundary row at ``S + q*rmax +
    i``)."""
    S = num_nodes_padded // P
    out: Dict[str, Any] = {"S": S, "P": P}
    for key in keys:
        src, nbr = mode_edge_set(graph["edge_index"], key, num_nodes)
        src, nbr = src.astype(np.int64), nbr.astype(np.int64)
        owner = src // S
        order = native.counting_argsort(owner.astype(np.int32), P)
        bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(owner, minlength=P))])
        sends = [[np.zeros(0, np.int64)] * P for _ in range(P)]
        blocks = []
        for p in range(P):
            pos = order[bounds[p]:bounds[p + 1]]
            nbr_p = nbr[pos]
            remote = np.unique(nbr_p[nbr_p // S != p])
            owners = remote // S
            for q in range(P):
                if q != p:
                    sends[q][p] = remote[owners == q] % S
            blocks.append((pos, nbr_p, remote, owners))
        rmax = max(1, max(len(sends[q][p]) for q in range(P)
                          for p in range(P)))
        send = np.zeros((P, P, rmax), np.int64)
        for q in range(P):
            for p in range(P):
                send[q, p, :len(sends[q][p])] = sends[q][p]
        out[f"{key}_send"] = send
        out[f"{key}_pos"], out[f"{key}_src"], out[f"{key}_slot"] = [], [], []
        for p, (pos, nbr_p, remote, owners) in enumerate(blocks):
            # the rank of each remote row among its owner's
            first = np.searchsorted(owners, owners, side="left")
            remote_slot = S + owners * rmax + np.arange(len(remote)) - first
            slot = nbr_p - p * S
            far = nbr_p // S != p
            slot[far] = remote_slot[np.searchsorted(remote, nbr_p[far])]
            out[f"{key}_pos"].append(pos)
            out[f"{key}_src"].append(src[pos] - p * S)
            out[f"{key}_slot"].append(slot)
    return out


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never on a
    build without CUDA)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def backward_span(outputs, inputs):
    """The profiler span ``train.encode.backward`` over the backward from
    ``outputs`` to ``inputs``, on the thread that runs it: opened by the
    first gradient hook of ``outputs``, closed once every gradient of
    ``inputs`` that the backward computes is complete (or when the
    backward ends, if none is). Only inputs that an op made carry the
    hooks (a leaf's hook would outlive the graph). The hooks read the
    gradients and change nothing; register them only while a profiler
    records. When the backward ends the hooks are removed: they hold the
    graph's nodes in a reference cycle, which would keep them, the
    leaves' gradient accumulators among them, until a garbage collection.
    A later step would reuse those accumulators, and each runs on the
    stream it was made on: a CUDA graph captured on another stream then
    fails."""
    outputs = [t for t in outputs if t.requires_grad]
    inputs = [t for t in inputs if t.grad_fn is not None]
    if not outputs or not inputs:
        return
    record = None
    handles = []

    def close(*_):
        nonlocal record
        if record is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(record)
            record = None

    def finish():
        close()
        for handle in handles:
            handle.remove()

    def open_(_):
        nonlocal record
        if record is None:
            record = torch.ops.profiler._record_function_enter_new(
                "train.encode.backward", None)
            torch.autograd.Variable._execution_engine.queue_callback(finish)

    handles.append(torch.autograd.graph.register_multi_grad_hook(
        outputs, open_, mode="any"))
    handles.append(torch.autograd.graph.register_multi_grad_hook(
        inputs, close, mode="all"))


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
        try:
            self.neighbor_block_size = int(
                self.get_option("neighbor_block_size"))
        except KeyError:
            self.neighbor_block_size = 16
        if self.neighbor_block_size > 0:
            config.log(
                f"{configuration_key}.neighbor_block_size "
                f"{self.neighbor_block_size} is ignored as a layout: "
                "kge_tpu_torch aggregates over the edge list (gather + "
                "index_add_), which gives kge_tpu's row blocks' numbers up "
                "to summation order; it still selects the halo route under "
                "a mesh and the dense adjacency's edge sets, as in kge_tpu")
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

    @property
    def spectral_sets(self) -> Tuple[str, ...]:
        """The edge sets of the modes of the layers that take the spectral
        route (``MessagePassingLayer.spectral``): their orders are built
        with the graph."""
        keys = set()
        for l in self.layers:
            if isinstance(l, MessagePassingLayer) and l.spectral:
                keys.update(k for k in map(l.rb_key, l.modes) if k)
        return tuple(sorted(keys))

    @property
    def row_block_modes(self) -> Tuple[str, ...]:
        """``kge_tpu``'s names of the edge sets its message-passing
        layers aggregate over in row blocks (none with
        ``neighbor_block_size`` 0, none for per-relation propagation):
        the edge sets of the dense adjacency and of the halo layout."""
        if self.neighbor_block_size <= 0:
            return ()
        keys = set()
        for l in self.layers:
            if isinstance(l, MessagePassingLayer):
                keys.update(k for k in map(l.rb_key, l.modes) if k)
        return tuple(sorted(keys))

    @property
    def halo_route(self) -> bool:
        """Whether the layers take the halo route under a model axis
        above 1: ``kge_tpu``'s hoistable and attention message-passing
        layers with row blocks (the layers of an encoder share these
        options, so they share the route; the others take the gathered
        route)."""
        return self.neighbor_block_size > 0 and all(
            isinstance(l, MessagePassingLayer)
            and not l.propagation.startswith("per_relation")
            and (l.hoistable or l.attention) for l in self.layers)

    def dense_adjacency_modes(self, device_type: str) -> Tuple[str, ...]:
        """``kge_tpu``'s edge sets whose aggregation runs as one dense
        ``[N, N] @ [N, d]`` product (``tpu.gnn_dense_adjacency``): a
        static per-edge scale (hoistable composition, no attention, no
        learned relation weight, no edge or self-edge dropout) and for
        ``sub`` a relation-term matrix of at most 64M elements;
        ``always`` raises where that fails, ``auto`` engages on the card
        only, within ``gnn_dense_adjacency_limit_bytes``."""
        config = self.config
        mode = config.check("tpu.gnn_dense_adjacency",
                            ["auto", "always", "never"])
        dtype = config.check("tpu.gnn_dense_adjacency_dtype",
                             ["float32", "bfloat16"])
        if mode == "never" or not self.layers:
            return ()
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
                if l.num_entities * R1 > C_MATRIX_MAX_ELEMENTS:
                    reasons.append(
                        f"{l.name}: 'sub' needs the C-matrix relation "
                        f"term, too large at N*R = {l.num_entities * R1}")
        if reasons:
            if mode == "always":
                raise ValueError(
                    "tpu.gnn_dense_adjacency=always is not applicable here: "
                    + "; ".join(reasons))
            return ()
        if mode == "auto":
            if device_type == "cpu":
                return ()
            N = self.layers[0].num_entities
            size = 4 if dtype == "float32" else 2
            if N * N * size > int(config.get(
                    "tpu.gnn_dense_adjacency_limit_bytes")):
                return ()
        return self.row_block_modes

    def init_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for l in self.layers:
            state.update(l.init_state())
        return state

    def forward(self, x, r, graph, ctx: Ctx):
        """The layers over the graph. On the halo route (``graph["halo"]``)
        ``x`` is this rank's row block of the padded table; the output is
        the whole ``[N, d]`` table either way."""
        # bf16 embeddings (tpu.compute_dtype) meet every layer's float32
        # weights first, a product jnp promotes: the layers run in float32
        x, r = (t.float() if t.dtype == torch.bfloat16 else t for t in (x, r))
        halo = graph.get("halo")
        N = self.dataset.num_entities()
        for layer in self.layers:
            if self.layer_type == "torch_rgcn":
                x = self.activation(x)  # rgcn activates before the layer
            x, r = layer(x, r, graph, ctx)
            if self.layer_type in ("message_passing", "weighted_gcn"):
                x = self.activation(x)
            if halo is not None:
                x = ctx.dropout_at(x, self.emb_entity_dropout, N,
                                   halo["rows"])
            else:
                x = ctx.dropout(x, self.emb_entity_dropout, replicated=True)
        if halo is not None:
            x = gather_table(x, halo["group"], halo["index"])[:N]
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
        self.use_stale_embeddings = self.get_option("use_stale_embeddings")
        self.device = torch.device(device)
        #: the mesh of the halo route (set by ``prepare_job``)
        self._mesh = None
        #: the halo layout of every block (``build_halo_layout``)
        self.halo_layout: Optional[Dict[str, Any]] = None
        self._graph_np: Dict[str, Any] = {}
        self._graph: Dict[str, Any] = {}
        #: bumped by every rebuild of the graph's tensors
        self.graph_version = 0
        self.set_graph(None)

    def set_graph(self, triples: Optional[np.ndarray]):
        """(Re)build the edge buffers on the device, the halo layout under
        a mesh and the dense adjacency where it engages; None means the
        full training split."""
        if triples is None:
            triples = self.dataset.split(self.config.get("train.split"))
        self._graph_np = build_graph_buffers(
            np.asarray(triples), self.dataset.num_relations(),
            self.rgnn.needs_rel_buckets,
            num_entities=self.dataset.num_entities(),
            spectral_sets=self.rgnn.spectral_sets,
        )
        # int64 index tensors: every indexing op takes them as they are
        self._graph = {
            k: v if isinstance(v, int) else torch.as_tensor(
                v.astype(np.int64), device=self.device)
            for k, v in self._graph_np.items() if k != "spectral"
        }
        if "spectral" in self._graph_np:  # the kernel's int32 orders
            self._graph["spectral"] = {
                key: {name: order.to(self.device)
                      for name, order in orders.items()}
                for key, orders in self._graph_np["spectral"].items()}
        self._maybe_build_halo()
        self._maybe_build_dense()
        self.graph_version += 1

    def _maybe_build_halo(self):
        """The halo route's layout of this rank's block (``graph["halo"]``)
        under a mesh with a model axis above 1, where a layer takes it."""
        self._graph.pop("halo", None)
        self.halo_layout = None
        if self._mesh is None:
            return
        mesh, N = self._mesh, self.dataset.num_entities()
        P, p = mesh.shape["model"], mesh.model_index
        keys = self.rgnn.row_block_modes
        if self.rgnn.halo_route:
            layout = build_halo_layout(
                self._graph_np, keys, P,
                self.entity_embedder.padded_vocab_size, N)
            S, dev = layout["S"], self.device
            ids = torch.arange(p * S, (p + 1) * S, device=dev)
            self._graph["halo"] = {
                "group": mesh.group("model"), "index": p, "S": S,
                "num_nodes": N, "rows": ids.clamp(max=N - 1),
                "valid": (ids < N).to(torch.float32),
                **{part: {k: torch.as_tensor(
                    layout[f"{k}_{part}"][p], dtype=torch.int64, device=dev)
                    for k in keys}
                   for part in ("send", "pos", "src", "slot")},
            }
            self.halo_layout = layout
        if not getattr(self, "_route_logged", False):
            self._route_logged = True
            if self.halo_layout is None:
                self.config.log(f"R-GNN encoder under a model axis of {P}: "
                                "the gathered route")
            else:
                _, how = dist.all_to_all_route(self.device.type)
                widths = {k: layout[f"{k}_send"].shape[2] for k in keys}
                self.config.log(
                    f"R-GNN encoder under a model axis of {P}: the halo "
                    f"route ({P} blocks of {layout['S']} rows, boundary "
                    f"widths {widths}; all_to_all: {how})")

    def _maybe_build_dense(self):
        """The dense ``[N, N]`` adjacency of each edge set where it engages
        (``Rgnn.dense_adjacency_modes``; none under a model axis above
        1), built on the device: the edges' scales (the degree norm over
        all-ones masks, or ones) summed into a float32 matrix
        (``index_put_`` with accumulation), stored in
        ``tpu.gnn_dense_adjacency_dtype``, as ``kge_tpu`` builds it."""
        for key in [k for k in self._graph if k.startswith("dense_")]:
            del self._graph[key]
        keys = self.rgnn.dense_adjacency_modes(self.device.type)
        mesh = self._mesh or mesh_lib.active()
        if not keys or (mesh is not None and mesh.shape["model"] > 1):
            return
        N = self.dataset.num_entities()
        dtype = (torch.float32 if self.config.get(
            "tpu.gnn_dense_adjacency_dtype") == "float32" else torch.bfloat16)
        use_norm = any(getattr(l, "use_edge_norm", False)
                       for l in self.layers)
        for key in keys:
            src, nbr = (torch.as_tensor(a.astype(np.int64), device=self.device)
                        for a in mode_edge_set(self._graph_np["edge_index"],
                                               key, N))
            ones = torch.ones(src.shape[0], device=self.device)
            scale = degree_norm(src, nbr, ones, N) if use_norm else ones
            A = torch.zeros((N, N), device=self.device)
            A.index_put_((src, nbr), scale, accumulate=True)
            self._graph[f"dense_{key}"] = A.to(dtype)
        self.config.log(f"Using the dense {N} x {N} adjacency "
                        f"({str(dtype)[6:]}) of {', '.join(keys)}")

    def prepare_job(self, job):
        """A training job's mesh with a model axis above 1 puts the
        layers that can take it on the halo route."""
        mesh = getattr(job, "mesh", None)
        if mesh is not None and mesh.shape["model"] > 1:
            self._mesh = mesh
            self._maybe_build_halo()
            self._maybe_build_dense()
            self.graph_version += 1

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
        with train_span(ctx, "train.encode"):
            halo = self._graph.get("halo")
            if halo is not None:
                x0 = self.entity_embedder.embed_block(ctx, halo["rows"])
            else:
                x0 = self.entity_embedder.embed_all(ctx)
            r0 = self.relation_embedder.embed_all(ctx)
            x, r = self.rgnn(x0, r0, self._graph, ctx)
            if not self.reciprocal_scorer:
                r = r[: self.dataset.num_relations()]
        if (ctx.train and torch.autograd._profiler_enabled()
                and not capturing()):
            backward_span((x, r), (x0, r0))
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

    @property
    def graph_version(self) -> int:
        return self.encoder.graph_version

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        self.encoder.prepare_job(job)

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
