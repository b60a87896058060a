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

import contextlib
import functools
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models.init import initialize, select_initialize_args
from kge_tpu_torch.parallel.distributed import put_global
from kge_tpu_torch.utils.misc import init_from
from kge_tpu_torch.utils.params import (
    params_from_state_dict, state_dict_from_params, tree_map
)

S, P, O = 0, 1, 2


def promoted(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their common dtype by numpy's (and ``jnp``'s)
    promotion: bf16 with float32 gives float32. Under
    ``tpu.compute_dtype: bfloat16`` the embeddings are bf16 and the
    scorers' weights float32; ``jnp`` promotes such a product, where
    torch's matmul, einsum and conv raise."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors))
    return tuple(t.to(dtype) for t in tensors)


class Ctx:
    """Per-call context: mode, randomness and non-trainable state.

    A default-constructed Ctx is eval mode with no randomness. In training
    mode (``Ctx(train=True, generator=g)``) dropout draws its masks from
    ``generator``, a ``torch.Generator`` on the tensors' device (the
    counterpart of ``kge_tpu``'s PRNG key in its Ctx).

    ``state`` holds non-trainable tensors (batch-norm running statistics)
    read during the call; layers write updated values into ``updates``,
    which the training job copies into the model state's tensors after
    the step (in place: a captured step reads them where they are).

    ``tables`` substitutes embedding tables for one call, by embedder name
    (``"entity_embedder"``, ``"relation_embedder"``): a row-sparse training
    step passes the rows it gathered, and indexes that point into them
    (the counterpart of ``kge_tpu``'s loss over a params tree whose
    ``weights`` are the gathered rows).

    ``cache`` is a memo for the life of the Ctx (one training step or
    subbatch, one evaluation batch): an R-GNN encoder keeps its output
    there, so every score call of the step reads one encoder forward and
    autograd flows through that one graph.

    ``shard`` (a ``BatchShard``) is set in a training step under a
    device mesh: the call computes rows ``[lo, hi)`` of a part of
    ``total`` rows of the global batch, and ``group`` is the data group
    that holds the other rows. Dropout then draws the global part's
    masks and keeps its rows, and batch norm takes the global part's
    statistics, so the mesh computes what one device does. Index
    tensors every rank holds whole (a shared negative sample) are
    ``mark_replicated``: their embeddings draw masks of their own
    shape."""

    def __init__(self, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 state: Optional[Dict[str, Any]] = None,
                 tables: Optional[Mapping[str, torch.Tensor]] = None,
                 shard: Optional["BatchShard"] = None):
        self.train = train
        self.generator = generator
        self.state = state if state is not None else {}
        self.updates: Dict[str, Any] = {}
        self.tables = dict(tables or {})
        self.cache: Dict[str, Any] = {}
        self.shard = shard
        self._replicated: set = set()

    def mark_replicated(self, indexes: torch.Tensor):
        """``indexes`` are the same on every rank (not batch rows)."""
        self._replicated.add(id(indexes))

    def is_replicated(self, indexes: Optional[torch.Tensor]) -> bool:
        return indexes is not None and id(indexes) in self._replicated

    def dropout(self, x: torch.Tensor, rate: float,
                replicated: bool = False) -> torch.Tensor:
        """``kge_tpu``'s dropout: ``where(bernoulli(keep), x / keep, 0)``
        in training, the identity otherwise. Under a ``shard``, ``x``'s
        leading axis holds k rows for each of the shard's batch rows
        (unless ``replicated``): the mask is drawn for the global part's
        ``k * total`` rows and this rank's block of them is kept."""
        if not self.train or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("this computation needs a generator in its Ctx")
        keep = 1.0 - rate
        shape, block = x.shape, None
        if self.shard is not None and not replicated:
            lo, hi, total = self.shard.lo, self.shard.hi, self.shard.total
            k, rest = divmod(x.shape[0], hi - lo)
            if rest:
                raise ValueError(
                    f"dropout under a mesh: {x.shape[0]} rows are not a "
                    f"multiple of the shard's {hi - lo} batch rows (mark "
                    "replicated index tensors with Ctx.mark_replicated)")
            shape, block = (k * total, *x.shape[1:]), slice(k * lo, k * hi)
        mask = torch.rand(shape, generator=self.generator,
                          dtype=x.dtype, device=x.device) < keep
        if block is not None:
            mask = mask[block]
        return torch.where(mask, x / keep, 0.0)

    def dropout_at(self, x: torch.Tensor, rate: float, total: int,
                   index: torch.Tensor) -> torch.Tensor:
        """The dropout of rows ``index`` of a tensor of ``total`` rows
        (the rest of its shape ``x``'s): the mask ``dropout`` would draw
        for the whole tensor, at those rows (an R-GNN layer's row block
        or edges under a mesh)."""
        if not self.train or rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("this computation needs a generator in its Ctx")
        keep = 1.0 - rate
        mask = torch.rand((total, *x.shape[1:]), generator=self.generator,
                          dtype=x.dtype, device=x.device) < keep
        return torch.where(mask[index], x / keep, 0.0)


def _same_layout(a: Any, b: Any) -> bool:
    """Whether two state trees have the same keys and tensor shapes."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _same_layout(a[k], b[k]) for k in a)
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.shape == b.shape)


@torch.no_grad()
def copy_state(target: Dict[str, Any], source: Mapping[str, Any]):
    """Copy the tensors of ``source`` into those of ``target`` (a model
    state tree holding at least ``source``'s keys), in place."""
    for key, value in source.items():
        if isinstance(value, Mapping):
            copy_state(target[key], value)
        else:
            target[key].copy_(value)


class BatchShard(NamedTuple):
    """Rows ``[lo, hi)`` of a part of ``total`` rows of the global
    batch, computed on this rank; ``group``: the data group (None on one
    data rank)."""
    lo: int
    hi: int
    total: int
    group: Any


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

    def init_state(self) -> Dict[str, Any]:
        """Initial non-trainable state (batch-norm statistics, ...)."""
        return {}

    def penalties(self, ctx: Ctx, **kwargs) -> List[Tuple[str, torch.Tensor]]:
        """(name, scalar) regularization terms."""
        return []


class RelationalScorer(KgeBase):
    """Scores (s,p,o) embedding combinations.

    Bilinear scorers additionally expose the *dot form*
    (``supports_dot_form = True``): for combine "sp_" (fixed=(s,p)) or
    "_po" (fixed=(p,o)), scores factor as ``query_vec(fixed) @
    candidate_vec(cand).T`` — the contract the fused rank-count
    evaluation kernel builds on.
    """

    supports_dot_form = False

    #: combines the dot form covers. ConvE/Transformer are sp_-only:
    #: enough for reciprocal-wrapped ranking (both sides rewrite to sp_),
    #: not for a bare model's _po side.
    dot_combines = ("sp_", "_po")

    def __init__(self, config: Config, dataset: Dataset,
                 configuration_key=None, *,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        """Scorers with weights of their own (ConvE, Transformer) draw
        them from ``generator`` on ``device``, or leave them unset with
        ``init_for_load_only``."""
        super().__init__(config, dataset, configuration_key)
        self.device = torch.device(device) if device is not None else None

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

    def _generic_combine(self, s_emb, p_emb, o_emb, combine: str,
                         ctx: Ctx) -> torch.Tensor:
        """Cross-product form built from row-wise spo scoring: the rows
        of every (query, free-slot candidate) pair are broadcast to one
        [n * m, d] batch and scored at once (``kge_tpu`` maps the spo
        scorer over the candidates instead; the scores are the same).

        Output row i is query i; the column axis enumerates the free slot
        (reference contract: kge/model/kge_model.py:151-213)."""
        if combine == "sp_":
            fixed, free = (s_emb, p_emb), o_emb
        elif combine == "_po":
            fixed, free = (p_emb, o_emb), s_emb
        elif combine == "s_o":
            fixed, free = (s_emb, o_emb), p_emb
        else:
            raise ValueError(f"cannot handle combine={combine!r}")
        n, m = fixed[0].shape[0], free.shape[0]

        def rows(x):  # each query row repeated for every candidate
            return x[:, None, :].expand(n, m, x.shape[1]).reshape(n * m, -1)

        cand = free[None, :, :].expand(n, m, free.shape[1]).reshape(n * m, -1)
        a, b = rows(fixed[0]), rows(fixed[1])
        if combine == "sp_":
            out = self.score_emb_spo(a, b, cand, ctx)
        elif combine == "_po":
            out = self.score_emb_spo(cand, a, b, ctx)
        else:
            out = self.score_emb_spo(a, cand, b, ctx)
        return out.reshape(n, m)


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

    def local_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of the padded table and their validity (see
        ``LookupEmbedder.local_rows``)."""
        raise NotImplementedError

    @torch.no_grad()
    def normalize_params(self):
        """Post-step parameter constraint (e.g. Lp normalization), in
        place."""


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
                 init_for_load_only: bool = False,
                 create_embedders: bool = True):
        """``scorer`` is a scorer class (built here, on ``device``) or a
        scorer instance; ``create_embedders=False`` leaves the embedders
        to the subclass (the reciprocal wrapper shares its base model's)."""
        super().__init__(config, dataset, configuration_key)
        if not init_for_load_only and generator is None:
            raise ValueError(
                "creating a model with fresh weights needs a generator "
                "(or init_for_load_only=True)"
            )
        self.device = torch.device(device)
        if isinstance(scorer, type):
            scorer = scorer(config, dataset, self.configuration_key,
                            device=device, generator=generator,
                            init_for_load_only=init_for_load_only)
        self.scorer: RelationalScorer = scorer
        if create_embedders:
            for name, vocab_size in (
                ("entity_embedder", dataset.num_entities()),
                ("relation_embedder", dataset.num_relations()),
            ):
                setattr(self, name, KgeEmbedder.create(
                    config, dataset, self.configuration_key + "." + name,
                    vocab_size, device=device, generator=generator,
                    init_for_load_only=init_for_load_only,
                ))
        #: non-trainable state (``kge_tpu``'s model state: ConvE's
        #: batch-norm statistics), a nested dict of tensors on the device
        self.model_state: Dict[str, Any] = self.init_state()

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
        """Rebuild the model of a checkpoint, weights and state loaded, on
        ``device`` (reference: kge/model/kge_model.py:552-585)."""
        import tempfile

        config = Config.create_from(checkpoint)
        if use_tmp_log_folder:
            config.log_folder = tempfile.mkdtemp(prefix="kge-")
        dataset = Dataset.create_from(checkpoint, config, dataset)
        model = KgeModel.create(config, dataset, device=device,
                                init_for_load_only=True)
        model.load_params(checkpoint["model"]["params"])
        model.load_state(checkpoint["model"].get("state", {}))
        return model

    # ------------------------------------------------------------------ params

    def sharded_tables(self) -> Dict[str, Any]:
        """The parameters stored as this rank's row block under a mesh,
        by name, with their embedders (empty off a mesh)."""
        return {f"{prefix}.weights": module
                for prefix, module in self.named_modules()
                if getattr(module, "mesh", None) is not None
                and hasattr(module, "row_lo")}

    @contextlib.contextmanager
    def whole_tables(self):
        """Under a mesh, every sharded table gathered once for the block
        (an evaluation: its weights fixed, no gradient), so its lookups
        read that copy instead of reducing rows over the model group;
        nothing off a mesh."""
        sharded = list(self.sharded_tables().values())
        with torch.no_grad():
            for module in sharded:
                module.whole = module.full_table()
        try:
            yield
        finally:
            for module in sharded:
                module.whole = None

    def load_params(self, tree: Mapping[str, Any]):
        """Copy a ``kge_tpu``-layout params tree (nested dicts and lists
        of arrays, whole tables) into this model's parameters, on their
        device; a sharded table takes its rank's rows."""
        state = state_dict_from_params(tree)
        for name, module in self.sharded_tables().items():
            state[name] = put_global(state[name], module.mesh, True)
        with torch.no_grad():
            self.load_state_dict(state, strict=True)

    def params(self) -> Dict[str, Any]:
        """This model's parameters as a ``kge_tpu``-layout params tree of
        numpy arrays (empty dicts for parameterless parts, e.g. the
        scorer of a bilinear model), whole tables (under a mesh gathered
        over the model group: collective)."""
        sharded = self.sharded_tables()
        out = {}
        for name, child in self.named_children():
            state = child.state_dict()
            for key in list(state):
                module = sharded.get(f"{name}.{key}")
                if module is not None:
                    state[key] = module.full_table().detach()
            out[name] = params_from_state_dict(state)
        return out

    def init_state(self) -> Dict[str, Any]:
        # flat: scorer state keys (e.g. "bn1") address Ctx.state directly
        return self.scorer.init_state()

    def state(self) -> Dict[str, Any]:
        """The model state as a ``kge_tpu``-layout tree of numpy arrays."""
        return tree_map(lambda t: t.detach().cpu().numpy(),
                        self.model_state)

    def load_state(self, tree: Mapping[str, Any]):
        """Take a ``kge_tpu``-layout state tree (numpy arrays), on this
        model's device; an empty tree gives the initial state, as in
        ``kge_tpu``'s evaluation jobs. A tree of the current state's keys
        and shapes is copied into its tensors in place (a captured
        training step and the evaluation read them where they are);
        another one replaces them."""
        new = self.init_state() if not tree else tree_map(
            lambda a: torch.as_tensor(np.array(a, dtype=np.float32),
                                      device=self.device), tree)
        if _same_layout(self.model_state, new):
            copy_state(self.model_state, new)
        else:
            self.model_state = new

    def default_ctx(self) -> Ctx:
        """The eval-mode Ctx of a call that names none: no randomness, the
        model's own state."""
        return Ctx(state=self.model_state)

    def save_to(self, checkpoint: Dict) -> Dict:
        checkpoint["model"] = {"params": self.params(), "state": self.state()}
        return checkpoint

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def normalize_params(self):
        """Apply the embedders' parameter constraints (Lp
        normalization), in place; the training job calls it after every
        update."""
        self.get_s_embedder().normalize_params()
        self.get_p_embedder().normalize_params()

    def prepare_job(self, job, **kwargs):
        """Register the num_parameters trace hook on training jobs
        (reference: kge/model/kge_model.py:587-603)."""
        from kge_tpu_torch.train.train import TrainingJob

        if isinstance(job, TrainingJob):
            def append_num_parameters(job_):
                if job_.current_trace.get("epoch") is not None:
                    job_.current_trace["epoch"]["num_parameters"] = (
                        self.num_parameters()
                    )

            job.post_epoch_hooks.append(append_num_parameters)

    # ------------------------------------------------------------------ penalty

    def penalties(self, ctx: Ctx, batch: Optional[Dict] = None,
                  **kwargs) -> List[Tuple[str, torch.Tensor]]:
        """Regularization terms; with a batch, embedder penalties see the
        batch indexes (for frequency-weighted regularization). Shared s/o
        embedders are penalized twice, as in the reference
        (kge/model/kge_model.py:605-651)."""
        result = self.scorer.penalties(ctx, **kwargs)
        s_emb, p_emb = self.get_s_embedder(), self.get_p_embedder()
        if batch is not None and "triples" in batch:
            triples = batch["triples"]
            result += p_emb.penalties(ctx, indexes=triples[:, P])
            if s_emb is self.get_o_embedder():
                so = torch.stack([triples[:, S], triples[:, O]], dim=1)
                weighted = s_emb.get_option("regularize_args.weighted")
                terms = s_emb.penalties(ctx, indexes=so if weighted else None)
                if not weighted:
                    terms = [(name, 2.0 * value) for name, value in terms]
                result += terms
            else:
                result += s_emb.penalties(ctx, indexes=triples[:, S])
                result += self.get_o_embedder().penalties(
                    ctx, indexes=triples[:, O])
        else:
            result += p_emb.penalties(ctx)
            terms = s_emb.penalties(ctx)
            result += [(name, 2.0 * value) for name, value in terms]
        return result

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
        ctx = ctx or self.default_ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        return self.scorer.score_emb_spo(s_emb, p_emb, o_emb, ctx)

    def score_sp(self, s, p, o_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or self.default_ctx()
        s_emb = self.get_s_embedder().embed(s, ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        if o_subset is not None:
            o_emb = self.get_o_embedder().embed(o_subset, ctx)
        else:
            o_emb = self.get_o_embedder().embed_all(ctx)
        return self.scorer.score_emb(s_emb, p_emb, o_emb, "sp_", ctx)

    def score_po(self, p, o, s_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or self.default_ctx()
        if s_subset is not None:
            s_emb = self.get_s_embedder().embed(s_subset, ctx)
        else:
            s_emb = self.get_s_embedder().embed_all(ctx)
        p_emb = self.get_p_embedder().embed(p, ctx)
        o_emb = self.get_o_embedder().embed(o, ctx)
        return self.scorer.score_emb(s_emb, p_emb, o_emb, "_po", ctx)

    def score_so(self, s, o, p_subset=None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or self.default_ctx()
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
        ctx = ctx or self.default_ctx()
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

    def dot_candidates_local(self, ctx: Ctx):
        """(cand_sp, cand_po, valid): the candidate matrices of this
        rank's block of the padded entity table and the block's validity
        (padding rows 0), for the rank count's sharded call; off a mesh,
        of the whole padded table."""
        emb, valid = self.get_s_embedder().local_rows()
        return (self.scorer.candidate_vec(emb, "sp_", ctx),
                self.scorer.candidate_vec(emb, "_po", ctx), valid)
