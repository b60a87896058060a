"""Model core: embedders, relational scorers, and KgeModel (counterpart of
``kge_tpu/models/api.py``).

``kge_tpu`` keeps models as static host objects and passes an explicit
params pytree through pure functions. Here every model part is an
``nn.Module`` that owns its tables as ``nn.Parameter``s, named so that
``state_dict()`` keys are the paths of ``kge_tpu``'s params tree joined
with dots (``entity_embedder.weights``, ``relation_embedder.weights``);
``KgeModel.load_params`` and ``KgeModel.save_to`` carry trees across.

- ``KgeEmbedder.embed(indexes, ctx)`` / ``embed_all(ctx)``
- ``RelationalScorer.score_emb(s_emb, p_emb, o_emb, combine, ctx)`` with
  combine in {spo, sp_, _po, s_o}
- ``KgeModel`` wires embedders + scorer and exposes the same scoring
  entry points as ``kge_tpu`` (reference: kge/model/kge_model.py:665-771),
  with the params argument dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models.init import initialize, select_initialize_args
from kge_tpu_torch.utils.misc import init_from
from kge_tpu_torch.utils.params import (
    params_from_state_dict, state_dict_from_params
)

S, P, O = 0, 1, 2


class Ctx:
    """Per-call context: mode and non-trainable state. Only evaluation
    mode is ported; a default-constructed Ctx is eval mode."""

    def __init__(self, train: bool = False,
                 state: Optional[Dict[str, Any]] = None):
        self.train = train
        self.state = state if state is not None else {}

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.train or rate <= 0.0:
            return x
        raise NotImplementedError("dropout in training is not yet ported")


class KgeBase(nn.Module, Configurable):
    """Base for scorers/embedders/models: config access + initializer."""

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key=None):
        nn.Module.__init__(self)
        Configurable.__init__(self, config, configuration_key)
        self.dataset = dataset

    def initialize(self, generator: torch.Generator, shape) -> torch.Tensor:
        name = self.get_option("initialize")
        try:
            raw_args = self.get_option("initialize_args")
        except KeyError:
            raw_args = {}
        args = select_initialize_args(name, raw_args)
        return initialize(generator, shape, name, args)


class RelationalScorer(KgeBase):
    """Scores (s,p,o) embedding combinations.

    Bilinear scorers additionally expose the *dot form*
    (``supports_dot_form = True``): for combine "sp_" (fixed=(s,p)) or
    "_po" (fixed=(p,o)), scores factor as ``query_vec(fixed) @
    candidate_vec(cand).T`` — the contract the fused rank-count
    evaluation kernel builds on.
    """

    supports_dot_form = False

    #: combines the dot form covers
    dot_combines = ("sp_", "_po")

    # "native": q . c equals score_emb exactly (bilinear scorers).
    # "monotone": q . c is a strictly increasing transform of the score;
    # ranks are preserved, but the fused evaluator must compute true
    # scores through the same dot path so the tie tolerances apply in one
    # consistent score space.
    dot_score_space = "native"

    def query_vec(self, a_emb, p_emb, combine: str, ctx: Ctx) -> torch.Tensor:
        """Query-side vectors: a_emb is s for 'sp_' and o for '_po'."""
        raise NotImplementedError

    def candidate_vec(self, cand_emb, combine: str, ctx: Ctx) -> torch.Tensor:
        """Candidate-side vectors for the free slot of ``combine``."""
        raise NotImplementedError

    def score_emb_spo(self, s_emb, p_emb, o_emb, ctx: Ctx) -> torch.Tensor:
        return self.score_emb(s_emb, p_emb, o_emb, "spo", ctx).reshape(-1)

    def score_emb(self, s_emb, p_emb, o_emb, combine: str,
                  ctx: Ctx) -> torch.Tensor:
        raise NotImplementedError


class KgeEmbedder(KgeBase):
    """Maps indexes to embeddings from its own [vocab, dim] table."""

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key: str, vocab_size: int):
        super().__init__(config, dataset, configuration_key)
        self.vocab_size = vocab_size
        self.embedder_type = self.get_option("type")
        # per-key overrides resolve through get_default's type indirection
        self.dim: int = self.get_option("dim")

    @staticmethod
    def create(config: Config, dataset: Dataset, configuration_key: str,
               vocab_size: int, *, device: torch.device,
               generator: Optional[torch.Generator] = None,
               init_for_load_only: bool = False) -> "KgeEmbedder":
        try:
            embedder_type = config.get_default(configuration_key + ".type")
        except KeyError as e:
            raise KeyError(
                f"Can't find {configuration_key}.type in config"
            ) from e
        try:
            class_name = config.get(embedder_type + ".class_name")
        except KeyError as e:
            raise KeyError(
                f"Embedder type {embedder_type!r} (from "
                f"{configuration_key}.type) has no {embedder_type}.class_name"
                " — is the component YAML imported?"
            ) from e
        return init_from(
            class_name,
            config.modules(),
            config=config,
            dataset=dataset,
            configuration_key=configuration_key,
            vocab_size=vocab_size,
            device=device,
            generator=generator,
            init_for_load_only=init_for_load_only,
        )

    def embed(self, indexes: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        raise NotImplementedError

    def embed_all(self, ctx: Ctx) -> torch.Tensor:
        raise NotImplementedError


class KgeModel(KgeBase):
    """A KGE model: entity/relation embedders + relational scorer.

    Public scoring API (same contract as ``kge_tpu`` without the params
    argument): ``score_spo``, ``score_sp``, ``score_po``, ``score_so``,
    ``score_sp_po``, and the dot forms ``dot_queries``,
    ``dot_candidates``, ``dot_candidates_all``.
    """

    def __init__(self, config: Config, dataset: Dataset, scorer,
                 configuration_key=None, *, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key)
        self.scorer: RelationalScorer = scorer(
            config, dataset, self.configuration_key
        )
        if not init_for_load_only and generator is None:
            raise ValueError(
                "creating a model with fresh weights needs a generator "
                "(or init_for_load_only=True)"
            )
        for name, vocab_size in (
            ("entity_embedder", dataset.num_entities()),
            ("relation_embedder", dataset.num_relations()),
        ):
            setattr(self, name, KgeEmbedder.create(
                config, dataset, self.configuration_key + "." + name,
                vocab_size, device=device, generator=generator,
                init_for_load_only=init_for_load_only,
            ))

    # ------------------------------------------------------------------ factory

    @staticmethod
    def create(config: Config, dataset: Dataset, configuration_key=None, *,
               device: torch.device,
               generator: Optional[torch.Generator] = None,
               init_for_load_only: bool = False) -> "KgeModel":
        """The configured model on ``device``: weights drawn from
        ``generator``, or left unset with ``init_for_load_only`` (then
        ``load_params`` fills them)."""
        model_name = (
            config.get(configuration_key + ".type")
            if configuration_key
            else config.get("model")
        )
        try:
            class_name = config.get(model_name + ".class_name")
        except KeyError:
            config._import(model_name)
            class_name = config.get(model_name + ".class_name")
        return init_from(
            class_name,
            config.modules(),
            config=config,
            dataset=dataset,
            configuration_key=configuration_key or model_name,
            device=device,
            generator=generator,
            init_for_load_only=init_for_load_only,
        )

    @staticmethod
    def create_from(checkpoint: Dict, *, device: torch.device,
                    dataset: Optional[Dataset] = None,
                    use_tmp_log_folder: bool = True) -> "KgeModel":
        """Rebuild the model of a checkpoint, weights loaded, on
        ``device`` (reference: kge/model/kge_model.py:552-585)."""
        import tempfile

        config = Config.create_from(checkpoint)
        if use_tmp_log_folder:
            config.log_folder = tempfile.mkdtemp(prefix="kge-")
        dataset = Dataset.create_from(checkpoint, config, dataset)
        model = KgeModel.create(config, dataset, device=device,
                                init_for_load_only=True)
        model.load_params(checkpoint["model"]["params"])
        return model

    # ------------------------------------------------------------------ params

    def load_params(self, tree: Mapping[str, Any]):
        """Copy a ``kge_tpu``-layout params tree (nested dict of arrays)
        into this model's parameters, on their device."""
        with torch.no_grad():
            self.load_state_dict(state_dict_from_params(tree), strict=True)

    def params(self) -> Dict[str, Any]:
        """This model's parameters as a ``kge_tpu``-layout params tree of
        numpy arrays (empty dicts for parameterless parts, e.g. the
        scorer)."""
        return {
            name: params_from_state_dict(child.state_dict())
            for name, child in self.named_children()
        }

    def save_to(self, checkpoint: Dict) -> Dict:
        checkpoint["model"] = {"params": self.params(), "state": {}}
        return checkpoint

    # ------------------------------------------------------------------ access

    def get_s_embedder(self) -> KgeEmbedder:
        return self.entity_embedder

    def get_o_embedder(self) -> KgeEmbedder:
        return self.entity_embedder

    def get_p_embedder(self) -> KgeEmbedder:
        return self.relation_embedder

    def get_scorer(self) -> RelationalScorer:
        return self.scorer

    # ------------------------------------------------------------------ scoring

    def score_spo(self, s, p, o, direction: Optional[str] = None,
                  ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or Ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        return self.scorer.score_emb_spo(s_emb, p_emb, o_emb, ctx)

    def score_sp(self, s, p, o_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or Ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        if o_subset is not None:
            o_emb = self.get_o_embedder().embed(o_subset, ctx)
        else:
            o_emb = self.get_o_embedder().embed_all(ctx)
        return self.scorer.score_emb(s_emb, p_emb, o_emb, "sp_", ctx)

    def score_po(self, p, o, s_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or Ctx()
        if s_subset is not None:
            s_emb = self.get_s_embedder().embed(s_subset, ctx)
        else:
            s_emb = self.get_s_embedder().embed_all(ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        return self.scorer.score_emb(s_emb, p_emb, o_emb, "_po", ctx)

    def score_so(self, s, o, p_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or Ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        if p_subset is not None:
            p_emb = self.get_p_embedder().embed(p_subset, ctx)
        else:
            p_emb = self.get_p_embedder().embed_all(ctx)
        return self.scorer.score_emb(s_emb, p_emb, o_emb, "s_o", ctx)

    def score_sp_po(self, s, p, o, entity_subset=None,
                    ctx: Optional[Ctx] = None) -> torch.Tensor:
        """[n, 2m]: (s,p,?) scores then (?,p,o) scores over the entity
        subset."""
        ctx = ctx or Ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        if entity_subset is not None:
            all_entities = self.get_s_embedder().embed(entity_subset, ctx)
        else:
            all_entities = self.get_s_embedder().embed_all(ctx)
        sp_scores = self.scorer.score_emb(s_emb, p_emb, all_entities, "sp_",
                                          ctx)
        po_scores = self.scorer.score_emb(all_entities, p_emb, o_emb, "_po",
                                          ctx)
        return torch.cat([sp_scores, po_scores], dim=1)

    # ------------------------------------------------------------------ dot forms

    def supports_dot_ranking(self) -> bool:
        # a bare model ranks both sides natively, so the scorer must
        # provide both dot combines
        return self.scorer.supports_dot_form and \
            "_po" in self.scorer.dot_combines

    def dot_score_space(self) -> str:
        """"native" or "monotone" — see RelationalScorer.dot_score_space."""
        return self.scorer.dot_score_space

    def dot_queries(self, s, p, o, ctx: Ctx):
        """(q_sp [B, D1], q_po [B, D2]) such that ranking scores factor
        as q @ dot_candidates(ids).T — the fused rank-count contract."""
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        q_sp = self.scorer.query_vec(s_emb, p_emb, "sp_", ctx)
        q_po = self.scorer.query_vec(o_emb, p_emb, "_po", ctx)
        return q_sp, q_po

    def dot_candidates(self, entity_ids, ctx: Ctx, sides=("sp", "po")):
        """(cand_sp, cand_po) candidate matrices for the given entities;
        sides not requested come back as None."""
        emb = self.get_s_embedder().embed(entity_ids, ctx)
        cand_sp = (
            self.scorer.candidate_vec(emb, "sp_", ctx)
            if "sp" in sides else None
        )
        cand_po = (
            self.scorer.candidate_vec(emb, "_po", ctx)
            if "po" in sides else None
        )
        return cand_sp, cand_po

    def dot_candidates_all(self, ctx: Ctx, padded: bool = False):
        """Candidate matrices over the WHOLE entity vocabulary. For
        identity candidate transforms (ComplEx raw rows) this is a view
        of the embedding table itself — no gather, no copy — which the
        rank-count kernel reads in place. ``padded`` keeps the table's
        padding rows (callers mask them invalid)."""
        emb = self.get_s_embedder().embed_all(ctx, padded=padded)
        return (
            self.scorer.candidate_vec(emb, "sp_", ctx),
            self.scorer.candidate_vec(emb, "_po", ctx),
        )
