"""Lookup-table embedder: a [vocab, dim] ``nn.Parameter`` (counterpart of
``kge_tpu/models/embedder/lookup.py``; reference:
kge/model/embedder/lookup_embedder.py).

The table keeps ``kge_tpu``'s layout: its row count is padded up to a
multiple of lcm(8, ``tpu.mesh.model``) with zero rows, so tables cross
between the two packages in both directions.

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
            table = self.weights[: self.vocab_size]
            return [(name, weight / p * torch.sum(table.abs() ** p))]
        if indexes is None:
            raise ValueError("weighted regularization needs batch indexes")
        idx = indexes.reshape(-1)
        rows = torch.index_select(self._table(ctx), 0, idx)
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

    def embed(self, indexes: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        emb = embedding_lookup(self._table(ctx), indexes)
        return self._cast(ctx.dropout(emb, self.dropout_rate), ctx)

    def embed_all(self, ctx: Ctx, padded: bool = False) -> torch.Tensor:
        """All embeddings: a view of the table's first ``vocab_size`` rows
        (with ``padded``, the whole padded table)."""
        if self.table_key in ctx.tables:
            raise ValueError(
                f"{self.table_key}: embed_all reads the whole table, which a "
                "row-sparse step has replaced by its gathered rows")
        rows = self.weights if padded else self.weights[: self.vocab_size]
        return self._cast(ctx.dropout(rows, self.dropout_rate), ctx)
