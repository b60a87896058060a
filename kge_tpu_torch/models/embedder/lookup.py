"""Lookup-table embedder: a [vocab, dim] ``nn.Parameter`` (counterpart of
``kge_tpu/models/embedder/lookup.py``; reference:
kge/model/embedder/lookup_embedder.py).

The table keeps ``kge_tpu``'s layout: its row count is padded up to a
multiple of lcm(8, ``tpu.mesh.model``) with zero rows, so tables cross
between the two packages in both directions.

Under a device mesh with a ``model`` axis above 1 (``parallel.mesh``)
``weights`` holds this rank's block of rows of the padded table (its
optimizer state follows its shape). ``embed`` reads rows through the
vocab-parallel lookup (owned rows, zeros elsewhere, summed over the
model group), ``embed_all`` gathers the whole table for the call
(``gather_table``: exact for every scorer; the table is materialised on
every rank for the duration of the step), and the unweighted penalty
sums each rank's rows over the group. ``local_rows`` is the block as it
is, for the rank count's sharded call. An evaluation gathers each table
once for its whole run (``KgeModel.whole_tables``) and looks rows up in
that copy.

Under ``tpu.compute_dtype: bfloat16`` a training call's embeddings are
cast to bf16 after dropout (``_cast``, as in ``kge_tpu``); the table,
its gradient and the optimizer state stay float32, and evaluation scores
in float32. ``lookup_embedder.pretrain.model_filename`` copies the rows
of a packaged model (of either package) whose external ids this dataset
has (``_pretrained_rows``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from kge_tpu_torch.models.api import Ctx, KgeEmbedder
from kge_tpu_torch.ops.embedding import embedding_lookup
from kge_tpu_torch.parallel import mesh as mesh_lib
from kge_tpu_torch.parallel.collectives import (
    gather_table, model_sum, vocab_lookup,
)
from kge_tpu_torch.utils.misc import round_to_points


class LookupEmbedder(KgeEmbedder):
    def __init__(self, config, dataset, configuration_key, vocab_size, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key, vocab_size)
        self.normalize_p: float = self.get_option("normalize.p")
        self.regularize: str = self.check_option("regularize", ["", "lp"])
        round_to = self.get_option("round_dim_to")
        if len(round_to) > 0:
            self.dim = round_to_points(round_to, self.dim)
        try:
            model_axis = max(1, config.get("tpu.mesh.model"))
        except KeyError:
            model_axis = 1
        align = model_axis * 8 // math.gcd(model_axis, 8)
        self.padded_vocab_size = -(-self.vocab_size // align) * align
        #: the key of this table in ``Ctx.tables`` (its attribute name in
        #: the model: ``entity_embedder``, ``relation_embedder``)
        self.table_key = configuration_key.rsplit(".", 1)[-1]
        try:
            self._compute_dtype = config.check(
                "tpu.compute_dtype", ["float32", "bfloat16"])
        except KeyError:
            self._compute_dtype = "float32"
        self.dropout_rate: float = self.get_option("dropout")
        if self.dropout_rate < 0:
            if config.get("train.auto_correct"):
                config.log(
                    f"Setting {configuration_key}.dropout to 0 "
                    f"(was {self.dropout_rate})."
                )
                self.dropout_rate = 0.0
        shape = (self.padded_vocab_size, self.dim)
        if init_for_load_only:
            weights = torch.empty(shape, dtype=torch.float32, device=device)
        else:
            weights = torch.zeros(shape, dtype=torch.float32, device=device)
            rows = self.initialize(generator, (self.vocab_size, self.dim))
            if self.normalize_p > 0:
                rows = self._lp_normalize(rows)
            pretrained = self._pretrained_rows()
            if pretrained is not None:
                own, rows_from = pretrained
                rows[own.to(rows.device)] = rows_from.to(rows.device)
            weights[: self.vocab_size] = rows.to(device)
        #: the mesh whose model group holds this table's row blocks
        #: (None: the whole table is here)
        self.mesh = mesh_lib.active()
        if self.mesh is not None and self.mesh.shape["model"] == 1:
            self.mesh = None
        self.row_lo = 0
        #: the whole table, gathered for an evaluation's run
        self.whole: Optional[torch.Tensor] = None
        if self.mesh is not None:
            # every rank draws the whole table from the shared generator
            # and keeps its block: the single-device initialisation
            self.row_lo, hi = self.mesh.rows(self.padded_vocab_size)
            weights = weights[self.row_lo:hi].clone()
        self.weights = nn.Parameter(weights, requires_grad=False)

    def _pretrained_rows(self):
        """(this table's row ids, their rows) from the packaged model named
        by ``pretrain.model_filename``: every row whose external id the
        package's id map has (``kge_tpu``'s ``_maybe_init_pretrained``;
        reference: kge/model/kge_model.py:290-340). None without a
        filename or a shared id."""
        try:
            filename = self.get_option("pretrain.model_filename")
        except KeyError:
            return None
        if not filename:
            return None
        from kge_tpu_torch.dataset import Dataset
        from kge_tpu_torch.utils.io import load_checkpoint

        checkpoint = load_checkpoint(filename)
        pre_dataset = Dataset.create_from(checkpoint)
        if "entity" in self.configuration_key:
            key, self_ids = "entity_embedder", self.dataset.entity_ids()
            pre_ids = pre_dataset.entity_ids()
        else:
            key, self_ids = "relation_embedder", self.dataset.relation_ids()
            pre_ids = pre_dataset.relation_ids()
        pre_lookup = {v: i for i, v in enumerate(pre_ids)}
        pairs = [(i, pre_lookup[v]) for i, v in enumerate(self_ids)
                 if v in pre_lookup]
        if (self.get_option("pretrain.ensure_all")
                and len(pairs) != len(self_ids)):
            raise ValueError(
                "pretrained model does not cover all ids "
                f"({len(pairs)}/{len(self_ids)})"
            )
        if not pairs:
            return None
        self.config.log(
            f"Initialized {len(pairs)}/{len(self_ids)} "
            f"{self.configuration_key} rows from {filename}"
        )
        own, pre = (torch.as_tensor(c) for c in zip(*pairs))
        table = torch.as_tensor(
            checkpoint["model"]["params"][key]["weights"])
        return own, table[pre]

    def _lp_normalize(self, weights: torch.Tensor) -> torch.Tensor:
        p = self.normalize_p
        norms = torch.sum(weights.abs() ** p, dim=-1, keepdim=True) ** (1.0 / p)
        return weights / torch.clamp(norms, min=1e-12)

    @torch.no_grad()
    def normalize_params(self):
        if self.normalize_p > 0:
            self.weights.copy_(self._lp_normalize(self.weights))

    def penalties(self, ctx: Ctx, indexes: Optional[torch.Tensor] = None,
                  **kwargs) -> List[Tuple[str, torch.Tensor]]:
        """The Lp penalty (reference: lookup_embedder.py penalty): over the
        whole table, or frequency-weighted over the batch's ``indexes``
        (every occurrence summed, divided by their number)."""
        if self.regularize == "" or self.get_option("regularize_weight") == 0.0:
            return []
        p = (
            self.get_option("regularize_args.p")
            if self.has_option("regularize_args.p")
            else 2
        )
        weight = self.get_option("regularize_weight")
        name = f"{self.configuration_key}.L{p}_penalty"
        if not self.get_option("regularize_args.weighted"):
            if self.mesh is None:
                table = self.weights[: self.vocab_size]
                return [(name, weight / p * torch.sum(table.abs() ** p))]
            # this rank's real rows, summed over the model group
            table = self.weights[: max(0, self.vocab_size - self.row_lo)]
            value = model_sum(torch.sum(table.abs() ** p),
                              self.mesh.group("model"))
            return [(name, weight / p * value)]
        if indexes is None:
            raise ValueError("weighted regularization needs batch indexes")
        idx = indexes.reshape(-1)
        rows = self._lookup(ctx, idx)
        value = weight / p * torch.sum(rows.abs() ** p) / idx.shape[0]
        return [(name, value)]

    # ------------------------------------------------------------------ embed

    def _table(self, ctx: Ctx) -> torch.Tensor:
        """The table to read: ``self.weights``, or the rows ``ctx``
        substitutes for it in a row-sparse step."""
        return ctx.tables.get(self.table_key, self.weights)

    def _cast(self, emb: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """Mixed precision: a training call's scorer math runs in
        ``tpu.compute_dtype``; evaluation scores in float32 for exact tie
        semantics."""
        if ctx.train and self._compute_dtype == "bfloat16":
            return emb.to(torch.bfloat16)
        return emb

    def _lookup(self, ctx: Ctx, indexes: torch.Tensor) -> torch.Tensor:
        """Rows ``indexes`` of the table (of the rows a row-sparse step
        substitutes for it, which every rank holds whole)."""
        if self.mesh is None or self.table_key in ctx.tables:
            return embedding_lookup(self._table(ctx), indexes)
        if self.whole is not None:
            return embedding_lookup(self.whole, indexes)
        return vocab_lookup(self.weights, indexes, self.row_lo,
                            self.mesh.group("model"))

    def full_table(self) -> torch.Tensor:
        """The whole padded table (gathered over the model group under a
        mesh; collective)."""
        if self.mesh is None:
            return self.weights
        if self.whole is not None:
            return self.whole
        return gather_table(self.weights, self.mesh.group("model"),
                            self.mesh.model_index)

    def local_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of the padded table and their validity (rows
        past ``vocab_size`` are padding), float32 [rows]: the whole table
        off a mesh."""
        ids = torch.arange(self.weights.shape[0], device=self.weights.device)
        valid = (ids + self.row_lo < self.vocab_size).to(torch.float32)
        return self.weights, valid

    def embed(self, indexes: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        emb = self._lookup(ctx, indexes)
        return self._cast(ctx.dropout(
            emb, self.dropout_rate,
            replicated=ctx.is_replicated(indexes)), ctx)

    def embed_block(self, ctx: Ctx, rows: torch.Tensor) -> torch.Tensor:
        """This rank's row block of the padded table as ``embed_all``
        reads it (its dropout mask drawn over all ``vocab_size`` rows, at
        ``rows``, the block's row ids clamped into the vocabulary; rows
        past it are zeros): the first R-GNN layer's input on its halo
        route. Its gradient is the block's own."""
        if self.mesh is None:
            raise ValueError("embed_block reads a row block of a mesh")
        table = self.weights
        if self.whole is not None:
            table = self.whole[self.row_lo:self.row_lo + table.shape[0]]
        return self._cast(ctx.dropout_at(table, self.dropout_rate,
                                         self.vocab_size, rows), ctx)

    def embed_all(self, ctx: Ctx, padded: bool = False) -> torch.Tensor:
        """All embeddings: a view of the table's first ``vocab_size`` rows
        (with ``padded``, the whole padded table); under a mesh, of the
        table gathered for this call."""
        if self.table_key in ctx.tables:
            raise ValueError(
                f"{self.table_key}: embed_all reads the whole table, which a "
                "row-sparse step has replaced by its gathered rows")
        table = self.full_table()
        rows = table if padded else table[: self.vocab_size]
        return self._cast(ctx.dropout(rows, self.dropout_rate,
                                      replicated=True), ctx)
