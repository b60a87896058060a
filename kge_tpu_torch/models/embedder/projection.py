"""Projection embedder: a linear map over a base embedder, and the Tucker3
relation embedder that expands relation vectors to entity_dim^2 mixing
matrices (counterpart of ``kge_tpu/models/embedder/projection.py``;
reference: kge/model/embedder/projection_embedder.py,
tucker3_relation_embedder.py).

The params tree is ``kge_tpu``'s, ``{"base": {...}, "projection": [out,
in]}``: the base embedder is the child ``base`` and the projection a
parameter applied as ``x @ W.T`` (torch ``Linear`` layout).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from kge_tpu_torch.models.api import Ctx, KgeEmbedder, promoted


class ProjectionEmbedder(KgeEmbedder):
    def __init__(self, config, dataset, configuration_key, vocab_size, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key, vocab_size)
        if not config.exists(self.configuration_key + ".base_embedder.type"):
            config.set(
                self.configuration_key + ".base_embedder.type",
                self.get_option("base_embedder.type"),
                create=True,
            )
        self.base = KgeEmbedder.create(
            config, dataset, self.configuration_key + ".base_embedder",
            vocab_size, device=device, generator=generator,
            init_for_load_only=init_for_load_only,
        )
        if self.dim < 0:
            self.dim = self.base.dim
        self.dropout_rate = self.get_option("dropout")
        self.regularize = self.check_option("regularize", ["", "lp"])
        shape = (self.dim, self.base.dim)
        if init_for_load_only:
            weights = torch.empty(shape, dtype=torch.float32, device=device)
        else:
            weights = self.initialize(generator, shape).to(device)
        self.projection = nn.Parameter(weights, requires_grad=False)

    def _project(self, emb: torch.Tensor, ctx: Ctx,
                 replicated: bool) -> torch.Tensor:
        emb, projection = promoted(emb, self.projection)
        return ctx.dropout(emb @ projection.T, self.dropout_rate,
                           replicated=replicated)

    def embed(self, indexes: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        return self._project(self.base.embed(indexes, ctx), ctx,
                             ctx.is_replicated(indexes))

    def embed_all(self, ctx: Ctx, padded: bool = False) -> torch.Tensor:
        return self._project(self.base.embed_all(ctx, padded=padded), ctx,
                             True)

    def local_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        rows, valid = self.base.local_rows()
        rows, projection = promoted(rows, self.projection)
        return rows @ projection.T, valid

    @torch.no_grad()
    def normalize_params(self):
        self.base.normalize_params()

    def penalties(self, ctx: Ctx, **kwargs) -> List[Tuple[str, torch.Tensor]]:
        result: List[Tuple[str, torch.Tensor]] = []
        if (self.regularize == "lp"
                and self.get_option("regularize_weight") != 0.0):
            p = self.get_option("regularize_args.p")
            weight = self.get_option("regularize_weight")
            norm = torch.sum(self.projection.abs() ** p) ** (1.0 / p)
            result.append((f"{self.configuration_key}.L{p}_penalty",
                           weight * norm))
        return result + self.base.penalties(ctx, **kwargs)


def rescal_set_relation_embedder_dim(config, dataset, rel_emb_conf_key: str):
    """If the relation embedder dim is <0, set it to entity_dim^2
    (reference: kge/model/rescal.py:78-95)."""
    dim = config.get_default(rel_emb_conf_key + ".dim")
    if dim < 0:
        ent_key = rel_emb_conf_key.replace("relation_embedder",
                                           "entity_embedder")
        if ent_key == rel_emb_conf_key:
            raise ValueError("cannot determine relation embedding size")
        dim = config.get_default(ent_key + ".dim") ** 2
        config.set(rel_emb_conf_key + ".dim", dim, create=True, log=True)


class Tucker3RelationEmbedder(ProjectionEmbedder):
    """ProjectionEmbedder producing entity_dim^2 relation mixing matrices."""

    def __init__(self, config, dataset, configuration_key, vocab_size,
                 **kwargs):
        rescal_set_relation_embedder_dim(config, dataset, configuration_key)
        super().__init__(config, dataset, configuration_key, vocab_size,
                         **kwargs)
        # schema-compat key the reference declares but never reads
        # (kge/model/embedder/tucker3_relation_embedder.yaml vs .py)
        normalize = self.get_option("normalize")
        if normalize:
            config.log(
                f"WARNING: {configuration_key}.normalize={normalize!r} has "
                "no effect (the reference ignores this key as well)"
            )
