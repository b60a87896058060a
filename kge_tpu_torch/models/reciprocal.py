"""Reciprocal relations wrapper: a doubled relation vocabulary
(counterpart of ``kge_tpu/models/reciprocal.py``; reference:
kge/model/reciprocal_relations_model.py).

(?, p, o) queries are rewritten as (o, p + R, ?), so the base model only
ever predicts objects. The base model is built over a shallow dataset
copy with 2R relations. The params tree is the base model's own, with no
``base_model`` level (``kge_tpu``'s): the wrapper registers the base
model's embedders and scorer as its own children, so its ``state_dict``
keys are ``entity_embedder.weights``, ``scorer.conv_w``, ..., and keeps
the base model itself outside the module tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from kge_tpu_torch.models.api import Ctx, KgeModel


class ReciprocalRelationsModel(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        self._init_configuration(config, configuration_key)
        alt_dataset = dataset.shallow_copy()
        alt_dataset._num_relations = dataset.num_relations() * 2
        alt_dataset._meta = dict(dataset._meta)
        try:
            rel_ids = list(dataset.relation_ids())
            alt_dataset._meta["relation_ids"] = rel_ids + [
                f"{r}_reciprocal" for r in rel_ids
            ]
        except (KeyError, OSError, TypeError):
            pass  # no relation id map (as kge_tpu, go on without names)
        base_model = KgeModel.create(
            config, alt_dataset, self.configuration_key + ".base_model",
            device=device, generator=generator,
            init_for_load_only=init_for_load_only,
        )
        super().__init__(
            config, dataset, base_model.get_scorer(),
            configuration_key=self.configuration_key, device=device,
            generator=generator, init_for_load_only=init_for_load_only,
            create_embedders=False,
        )
        self.entity_embedder = base_model.get_s_embedder()
        self.relation_embedder = base_model.get_p_embedder()
        # outside the module tree: its parameters are the children above
        self.__dict__["_base_model"] = base_model

    @torch.no_grad()
    def normalize_params(self):
        self._base_model.normalize_params()

    def prepare_job(self, job, **kwargs):
        self._base_model.prepare_job(job, **kwargs)

    def penalties(self, ctx: Ctx, batch=None, **kwargs):
        return self._base_model.penalties(ctx, batch=batch, **kwargs)

    def score_spo(self, s, p, o, direction=None, ctx=None):
        ctx = ctx or self.default_ctx()
        if direction == "o":
            return self._base_model.score_spo(s, p, o, "o", ctx)
        if direction == "s":
            return self._base_model.score_spo(
                o, p + self.dataset.num_relations(), s, "o", ctx)
        raise ValueError(
            "the reciprocal relations model cannot compute undirected spo "
            "scores"
        )

    def score_po(self, p, o, s_subset=None, ctx=None):
        ctx = ctx or self.default_ctx()
        if s_subset is not None:
            s_emb = self.get_s_embedder().embed(s_subset, ctx)
        else:
            s_emb = self.get_s_embedder().embed_all(ctx)
        p_emb = self.get_p_embedder().embed(
            p + self.dataset.num_relations(), ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        return self.scorer.score_emb(o_emb, p_emb, s_emb, "sp_", ctx)

    def score_so(self, s, o, p_subset=None, ctx=None):
        raise ValueError(
            "the reciprocal relations model cannot score relations")

    def supports_dot_ranking(self) -> bool:
        # both ranking sides rewrite to sp_ queries, so an sp_-only dot
        # form (ConvE, Transformer) suffices
        return self.scorer.supports_dot_form and \
            "sp_" in self.scorer.dot_combines

    def dot_queries(self, s, p, o, ctx: Ctx):
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        p_inv = self.get_p_embedder().embed(
            p + self.dataset.num_relations(), ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        q_sp = self.scorer.query_vec(s_emb, p_emb, "sp_", ctx)
        q_po = self.scorer.query_vec(o_emb, p_inv, "sp_", ctx)
        return q_sp, q_po

    def dot_candidates_all(self, ctx: Ctx, padded: bool = False):
        emb = self.get_s_embedder().embed_all(ctx, padded=padded)
        cand = self.scorer.candidate_vec(emb, "sp_", ctx)
        return cand, cand

    def dot_candidates_local(self, ctx: Ctx):
        emb, valid = self.get_s_embedder().local_rows()
        cand = self.scorer.candidate_vec(emb, "sp_", ctx)
        return cand, cand, valid

    def dot_candidates(self, entity_ids, ctx: Ctx, sides=("sp", "po")):
        # both query sides are sp_-form under reciprocal rewriting, so
        # one candidate matrix serves both; computed iff a side asks
        if not sides:
            return None, None
        emb = self.get_s_embedder().embed(entity_ids, ctx)
        cand = self.scorer.candidate_vec(emb, "sp_", ctx)
        return (cand if "sp" in sides else None,
                cand if "po" in sides else None)

    def score_sp_po(self, s, p, o, entity_subset=None, ctx=None):
        ctx = ctx or self.default_ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_inv = self.get_p_embedder().embed(
            p + self.dataset.num_relations(), ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        if entity_subset is not None:
            all_entities = self.get_s_embedder().embed(entity_subset, ctx)
        else:
            all_entities = self.get_s_embedder().embed_all(ctx)
        sp_scores = self.scorer.score_emb(s_emb, p_emb, all_entities, "sp_",
                                          ctx)
        po_scores = self.scorer.score_emb(o_emb, p_inv, all_entities, "sp_",
                                          ctx)
        return torch.cat([sp_scores, po_scores], dim=1)
