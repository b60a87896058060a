"""Lookup-table embedder: a [vocab, dim] ``nn.Parameter`` (counterpart of
``kge_tpu/models/embedder/lookup.py``; reference:
kge/model/embedder/lookup_embedder.py).

The table keeps ``kge_tpu``'s layout: its row count is padded up to a
multiple of lcm(8, ``tpu.mesh.model``) with zero rows, so tables cross
between the two packages in both directions.
"""

from __future__ import annotations

import math
from typing import Optional

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
        round_to = self.get_option("round_dim_to")
        if len(round_to) > 0:
            self.dim = round_to_points(round_to, self.dim)
        try:
            model_axis = max(1, config.get("tpu.mesh.model"))
        except KeyError:
            model_axis = 1
        align = model_axis * 8 // math.gcd(model_axis, 8)
        self.padded_vocab_size = -(-self.vocab_size // align) * align
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
            if self.get_option("pretrain.model_filename"):
                raise NotImplementedError(
                    "lookup_embedder.pretrain is not yet ported"
                )
            weights = torch.zeros(shape, dtype=torch.float32, device=device)
            rows = self.initialize(generator, (self.vocab_size, self.dim))
            if self.normalize_p > 0:
                rows = self._lp_normalize(rows)
            weights[: self.vocab_size] = rows.to(device)
        self.weights = nn.Parameter(weights, requires_grad=False)

    def _lp_normalize(self, weights: torch.Tensor) -> torch.Tensor:
        p = self.normalize_p
        norms = torch.sum(weights.abs() ** p, dim=-1, keepdim=True) ** (1.0 / p)
        return weights / torch.clamp(norms, min=1e-12)

    # ------------------------------------------------------------------ embed

    def embed(self, indexes: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        emb = embedding_lookup(self.weights, indexes)
        return ctx.dropout(emb, self.dropout_rate)

    def embed_all(self, ctx: Ctx, padded: bool = False) -> torch.Tensor:
        """All embeddings: a view of the table's first ``vocab_size`` rows
        (with ``padded``, the whole padded table)."""
        rows = self.weights if padded else self.weights[: self.vocab_size]
        return ctx.dropout(rows, self.dropout_rate)
