"""Negative-sampling training (counterpart of
``kge_tpu/train/train_negative_sampling.py``; reference:
kge/job/train_negative_sampling.py).

Per slot with num_samples > 0, scores are arranged [B, 1+num] (the
positive in column 0, the reference layout) and fed to the loss with
``num_negatives``. Scoring implementations, as in ``kge_tpu``:

- ``triple``: every corrupted triple scored on its own (``score_spo``
  with the slot as ``direction``, the positive's other slots repeated);
- ``all``: every candidate scored ([B, V]) and each row's sampled
  columns gathered;
- ``batch``: shared negatives score the batch's unique sample once
  ([B, num+1]) and gather each row's columns; non-shared negatives score
  the flattened sample of the subbatch and gather each row's block.

Graph sampling (``negative_sampling.graph_sampling``) draws the epoch's
triples from the epoch's generator (``train/graph_util.py``); an R-GNN
model's encoder takes the subgraph as its graph (``set_graph``).

With shared negatives and the ``kl`` loss, the slots s and o can take
the fused loss instead (``tpu.fused_negsamp_loss``): the scores, the
count-weighted logsumexp and the loss of a slot in one call of
``ops.negsamp_loss.shared_ce_loss``, the hand-written CUDA kernel on a
card. The batch then ships the count factors of its shared sample, which
expand to per-row multiplicities on the device.

Row-sparse updates (``tpu.sparse_updates``, ``kge_tpu``'s rules): each
host batch also ships the sorted ids of the entity and relation rows it
touches, its indexes remapped into them. The step gathers those rows,
computes the loss and penalty over them through a ``Ctx`` that
substitutes them for the tables, and the optimizer updates only them, in
place (``KgeOptimizer.sparse_row_update``; the row-update kernel on a
card). No [V, D] gradient exists in such a step.

On-device sampling (``tpu.on_device_sampling``, ``kge_tpu``'s rules in
``_resolve_on_device_sampling``): uniform shared negatives on the fused
loss path are drawn on the device (``sampler.device_shared_sample``, from
the job's sampling generator) at the start of each step
(``_expand_device_batch``); a batch is then only the positions of its
triples in the train split, and the epoch's positions and sizes go up
once (``_epoch_device_payload``).

Under a device mesh each rank scores its rows of the batch against the
replicated shared sample (marked so in the part's ``Ctx``): the fused
loss launches the kernel on the rank's rows, and the data group sums the
partial losses and gradients (``kge_tpu``'s ``shared_ce_loss_sharded``;
``tpu.fused_negsamp_loss: auto`` is off under a mesh, ``always`` takes
this route). A row-sparse step gathers its rows through the
vocab-parallel lookup, and each rank updates the rows its block owns
(``TrainingJob._owned_rows``). On-device draws are the same on every
rank (one seed), and each rank takes its rows of them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kge_tpu_torch.models import Ctx, KgeModel, ReciprocalRelationsModel
from kge_tpu_torch.models.embedder.lookup import LookupEmbedder
from kge_tpu_torch.ops.gather import row_gather
from kge_tpu_torch.ops.negsamp_loss import expand_counts, shared_ce_loss
from kge_tpu_torch.parallel import distributed as dist
from kge_tpu_torch.parallel.collectives import vocab_lookup
from kge_tpu_torch.train.graph_util import (
    sample_edge_neighbourhood, sample_uniform,
)
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.optimizer import sparse_unsupported_reason
from kge_tpu_torch.train.sampler import (
    SLOT_STR, SLOTS, KgeSampler, KgeUniformSampler, S, P, O,
    device_shared_sample,
)
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.seed import rng_seed_from_config


#: the tables a row-sparse run updates row by row
SPARSE_TABLES = ("entity_embedder.weights", "relation_embedder.weights")

#: ``kge_tpu``'s TPU-runtime forms of the row-sparse step and their
#: defaults; none changes a number, and the port has one form: they set
#: its group size only (``_steps_per_dispatch``)
_TPU_SPARSE_OPTIONS = {
    "tpu.sparse_table_chunks": "auto",
    "tpu.sparse_scatter_limit_bytes": "1073741824",
    "tpu.sparse_split_phases": "auto",
    "tpu.sparse_pipelined_gather": "auto",
    "tpu.sparse_group_rowset": "auto",
    "tpu.sparse_row_kernel": "auto",
}


class TrainingJobNegativeSampling(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        self._sampler = KgeSampler.create(config, "negative_sampling", dataset)
        np_seed = rng_seed_from_config(config, "numpy")
        if np_seed >= 0:
            self._sampler.seed(np_seed + 1)
        self.type_str = "negative_sampling"
        if self.__class__ == TrainingJobNegativeSampling:
            for f in Job.job_created_hooks:
                f(self)

    # ------------------------------------------------------------------ sparse updates

    def _sparse_table_paths(self):
        """Row-sparse embedding updates (``tpu.sparse_updates``; the
        counterpart of the torch sparse-Adagrad path behind
        ``lookup_embedder.sparse``): every index a negative-sampling step
        scores is known up front, so the step gathers those rows, takes
        the gradient of the loss over them, and updates only them and
        their optimizer state. ``kge_tpu``'s rules: ``auto`` turns it on
        where it gives the dense numbers and the entity table is at least
        32 times the rows a batch touches; ``always`` raises where it does
        not apply (an R-GNN encoder reads every row of both tables)."""
        config = self.config
        # canonical values are YAML-safe (unquoted on/off parse as YAML
        # booleans); accept legacy aliases
        raw = config.get("tpu.sparse_updates")
        aliases = {True: "always", False: "never", "on": "always",
                   "off": "never"}
        if raw in aliases:
            config.set("tpu.sparse_updates", aliases[raw], log=True)
        mode = config.check("tpu.sparse_updates", ["auto", "always", "never"])
        for key, default in _TPU_SPARSE_OPTIONS.items():
            if str(config.get(key)) != default:
                config.log(
                    f"{key} sets the steps a dispatch only, as in kge_tpu: "
                    "kge_tpu_torch updates each table as one tensor in "
                    "place (the row-update kernel on a card, its plain "
                    "version on the host); kge_tpu gives the same numbers "
                    "with any setting")
        if mode == "never":
            return ()
        m = self.model
        reasons = []
        r = sparse_unsupported_reason(config)
        if r:
            reasons.append(r)
        if config.get("train.subbatch_size") > 0:
            reasons.append("subbatch gradient accumulation is enabled")
        if config.get("negative_sampling.implementation") == "all":
            reasons.append("implementation 'all' scores every entity")
        if isinstance(m, ReciprocalRelationsModel):
            reasons.append("reciprocal model rewrites raw relation indices")
        if hasattr(m, "set_graph"):
            reasons.append("GNN encoder runs over the full graph")
        if type(m).penalties is not KgeModel.penalties:
            reasons.append(f"{type(m).__name__} defines whole-table penalties")
        if type(m).normalize_params is not KgeModel.normalize_params:
            reasons.append(f"{type(m).__name__} renormalizes full tables")
        for name, emb in (("entity", m.get_s_embedder()),
                          ("relation", m.get_p_embedder())):
            if type(emb) is not LookupEmbedder:
                reasons.append(f"{name} embedder is not a plain lookup table")
                continue
            if emb.normalize_p > 0:
                reasons.append(f"{name} embedder Lp-normalizes its table")
            if (emb.regularize
                    and emb.get_option("regularize_weight") != 0.0
                    and not emb.get_option("regularize_args.weighted")):
                reasons.append(f"{name} embedder has unweighted regularization")
        if not reasons and mode == "auto":
            # dense table updates cost O(V) per step, the sparse machinery
            # O(touched rows) plus constant overhead (unique, searchsorted,
            # scatter); only auto-enable with clear headroom
            ent_rows, _ = self._touched_row_counts()
            if self.dataset.num_entities() < 32 * ent_rows:
                reasons.append(
                    "entity vocabulary too small for sparse updates to pay "
                    f"({self.dataset.num_entities()} rows vs ~{ent_rows} "
                    "touched per batch)"
                )
        if reasons:
            if mode == "always":
                raise ValueError(
                    "tpu.sparse_updates=always is not applicable here: "
                    + "; ".join(reasons)
                )
            config.log(
                "Row-sparse updates not applicable: " + "; ".join(reasons))
            return ()
        config.log("Using row-sparse embedding updates.")
        return SPARSE_TABLES

    def _touched_row_counts(self):
        """Static (entity, relation) bounds on rows touched per batch."""
        config = self.config
        batch_size = config.get("train.batch_size")
        shared = config.get("negative_sampling.shared")
        ent_rows, rel_rows = 2 * batch_size, batch_size
        nums = {
            key: config.get(f"negative_sampling.num_samples.{key}")
            for key in ("s", "p", "o")
        }
        # mirror the sampler's auto-complete exactly (sampler.py: S copies
        # O's original value, then O copies S's resolved value; P -> 0)
        orig_o = nums["o"]
        if nums["s"] < 0:
            nums["s"] = orig_o if orig_o > 0 else 0
        if nums["o"] < 0:
            nums["o"] = nums["s"] if nums["s"] > 0 else 0
        if nums["p"] < 0:
            nums["p"] = 0
        for key, n in nums.items():
            if n <= 0:
                continue
            extra = n + 1 if shared else batch_size * n
            if key == "p":
                rel_rows += extra
            else:
                ent_rows += extra
        return ent_rows, rel_rows

    def _step_context(self, batch):
        """In a row-sparse run: gather the rows the batch touches (its
        ``uniq_e`` and ``uniq_r``) as leaves of their own, and a ``Ctx``
        that substitutes them for the tables; the batch's indexes already
        point into them (``_add_row_index_payload``)."""
        if not self._sparse_paths:
            return super()._step_context(batch)
        rows, tables = {}, {}
        sharded = self.model.sharded_tables()
        for path, key in zip(SPARSE_TABLES, ("uniq_e", "uniq_r")):
            uniq = batch[key]
            table = self.model.get_parameter(path).detach()
            module = sharded.get(path)
            if module is None:
                gathered = table.index_select(0, uniq)
            else:
                gathered = vocab_lookup(table, uniq, module.row_lo,
                                        module.mesh.group("model"))
            gathered.requires_grad_()
            rows[path] = (uniq, gathered)
            tables[path.split(".")[0]] = gathered
        return Ctx(train=True, state=self.model.model_state,
                   tables=tables), rows

    def _prepare(self):
        self._implementation = self.config.check(
            "negative_sampling.implementation",
            ["triple", "all", "batch", "auto"],
        )
        if self._implementation == "auto":
            # reference heuristic (train_negative_sampling.py:33-46)
            max_negs = int(max(self._sampler.num_samples))
            if self._sampler.shared:
                self._implementation = "batch"
            elif max_negs <= 30:
                self._implementation = "triple"
            else:
                self._implementation = "batch"
            self.config.set(
                "negative_sampling.implementation", self._implementation,
                log=True,
            )
        self.config.log(
            f"Preparing negative sampling with '{self._implementation}' "
            "scoring..."
        )
        self._fused_slots = self._resolve_fused_loss_slots()
        self.graph_sampling = self.config.check(
            "negative_sampling.graph_sampling",
            ["uniform", "edge_neighbourhood", "None"],
        )
        if self.graph_sampling == "None":
            self.graph_sampling = None
        self.graph_sampling_size = self.config.get(
            "negative_sampling.graph_sampling_size"
        )
        if self.graph_sampling:
            self.num_examples = self.graph_sampling_size
        else:
            self.num_examples = len(self.dataset.split(self.train_split))
        self._device_pool = None
        self._on_device_sampling = self._resolve_on_device_sampling()

    def _sample_graph(self, rng: np.random.Generator) -> np.ndarray:
        """The epoch's subgraph, drawn from the epoch's generator (so a
        resumed run draws the uninterrupted run's); an R-GNN encoder's
        edge buffers become it."""
        train = self.dataset.split(self.train_split)
        sample = (sample_uniform if self.graph_sampling == "uniform"
                  else sample_edge_neighbourhood)
        triples = sample(train, self.graph_sampling_size, rng)
        if hasattr(self.model, "set_graph"):
            self.model.set_graph(triples)
        return triples

    def _resolve_fused_loss_slots(self):
        """Slots whose loss goes through the fused kernel
        (``kge_tpu``'s rules; ``auto`` needs a CUDA device)."""
        mode = self.config.check(
            "tpu.fused_negsamp_loss", ["auto", "always", "never"]
        )
        if mode == "never":
            return ()
        m = self.model
        reasons = []
        if not self._sampler.shared:
            reasons.append("negatives are not shared")
        if self._implementation != "batch":
            reasons.append(
                f"implementation '{self._implementation}' is not 'batch'"
            )
        if self.config.get("train.loss") != "kl":
            reasons.append("train.loss is not kl (the kernel fuses the "
                           "log-softmax cross entropy)")
        if not m.supports_dot_ranking():
            reasons.append("model has no dot form")
        elif m.dot_score_space() != "native":
            reasons.append("dot form is a monotone transform, not the "
                           "native score")
        if mode == "auto" and self.device.type != "cuda":
            reasons.append("no CUDA device (the kernel runs on the card)")
        if mode == "auto" and self.mesh is not None:
            reasons.append("a device mesh (set always for the sharded "
                           "route)")
        if reasons:
            if mode == "always":
                raise ValueError(
                    "tpu.fused_negsamp_loss=always is not applicable here: "
                    + "; ".join(reasons)
                )
            return ()
        slots = tuple(s for s in (S, O) if self._sampler.num_samples[s] > 0)
        if slots:
            self.config.log(
                "Using the fused shared-negative loss kernel for slots "
                + ", ".join(SLOT_STR[s] for s in slots)
            )
        return slots

    def _steps_per_dispatch(self) -> int:
        """``kge_tpu``'s group size of a row-sparse run: 1 where its
        ``_sparse_host_loop_only`` holds (a split-phase or
        pipelined-gather step, or a table buffer over
        ``tpu.sparse_scatter_limit_bytes`` after its row chunks), at
        least 16 where it scans its row working set
        (``tpu.sparse_group_rowset: always`` with chunked tables), else
        ``tpu.steps_per_dispatch``: at the defaults its tables are
        chunked under the limit (``tpu.sparse_table_chunks: auto``), so
        it scans groups of 4 steps at Wikidata5M size too."""
        group = super()._steps_per_dispatch()
        if not self._sparse_paths:
            return group
        config = self.config
        modes = {key: config.check(f"tpu.sparse_{key}",
                                   ["auto", "always", "never"])
                 for key in ("split_phases", "pipelined_gather",
                             "group_rowset")}
        if "always" in (modes["split_phases"], modes["pipelined_gather"]):
            return 1  # host-side pending state between steps
        limit = int(config.get("tpu.sparse_scatter_limit_bytes"))
        chunks = self._table_chunks(limit)
        shards = self.mesh.shape["model"] if self.mesh is not None else 1
        per_buffer = 0
        for path, emb in zip(SPARSE_TABLES, (self.model.get_s_embedder(),
                                             self.model.get_p_embedder())):
            rows = emb.padded_vocab_size
            k = chunks.get(path, 1)
            if k > 1:  # kge_tpu's chunk_rows: a ceil split, 8-row aligned
                per_chunk = -(-rows // k)
                rows = -(-per_chunk // 8) * 8
            per_buffer = max(per_buffer, rows * emb.dim * 4 // shards)
        if per_buffer > limit:
            return 1
        if group > 1 and chunks and modes["group_rowset"] == "always":
            group = max(group, 16)  # kge_tpu amortizes its delta scatter
        return group

    def _table_chunks(self, limit: int) -> Dict[str, int]:
        """``kge_tpu``'s row chunks of each sparse table
        (``_resolve_table_chunks``): ``tpu.sparse_table_chunks`` auto
        splits a table over ``limit`` bytes into ceil(bytes / limit),
        ``never`` none, a count each table; none with the monolithic row
        kernel (``tpu.sparse_row_kernel: always``), under a mesh or over
        several processes. Only tables of more than one chunk."""
        raw = str(self.config.get("tpu.sparse_table_chunks")).strip()
        if (raw == "never"
                or self.config.get("tpu.sparse_row_kernel") == "always"
                or self.mesh is not None or dist.process_count() > 1):
            return {}
        if raw != "auto":
            try:
                forced = int(raw)
            except ValueError:
                raise ValueError(
                    "tpu.sparse_table_chunks must be auto, never, or a "
                    f"chunk count; got {raw!r}")
        out = {}
        for path, emb in zip(SPARSE_TABLES, (self.model.get_s_embedder(),
                                             self.model.get_p_embedder())):
            table_bytes = emb.padded_vocab_size * emb.dim * 4
            if raw == "auto":
                k = max(1, -(-table_bytes // limit)) if limit > 0 else 1
            else:
                k = max(1, forced)
            if k > 1:
                out[path] = k
        return out

    def _capture_unsupported_reasons(self):
        reasons = super()._capture_unsupported_reasons()
        if self.graph_sampling:
            reasons.append("graph sampling re-derives the triple pool per "
                           "epoch")
        return reasons

    # ------------------------------------------------------------------ on-device sampling

    def _resolve_on_device_sampling(self) -> bool:
        """Draw the shared negatives on the device instead of the host
        (``tpu.on_device_sampling``; ``kge_tpu``'s reasons, order, error
        and log line): uniform shared sampling on the fused-loss path."""
        mode = self.config.check(
            "tpu.on_device_sampling", ["auto", "always", "never"]
        )
        if mode == "never":
            return False
        reasons = []
        active = tuple(s for s in SLOTS if self._sampler.num_samples[s] > 0)
        if not active:
            reasons.append("no negative-sample slots are active")
        if not self._sampler.shared:
            reasons.append("negatives are not shared")
        if type(self._sampler) is not KgeUniformSampler:
            reasons.append("sampler is not uniform")
        missing = [SLOT_STR[s] for s in active if s not in self._fused_slots]
        if missing:
            reasons.append(
                f"slot(s) {', '.join(missing)} are not on the fused loss "
                "path (see tpu.fused_negsamp_loss)"
            )
        if self._sparse_paths:
            reasons.append("row-sparse updates uniquify realized negatives "
                           "on the host")
        if self.graph_sampling:
            reasons.append("graph sampling re-derives the triple pool "
                           "per epoch")
        for slot in active:
            num = int(self._sampler.num_samples[slot])
            voc = int(self._sampler.vocabulary_size[slot])
            if voc < num + 1:
                reasons.append(
                    f"vocabulary of slot {SLOT_STR[slot]} ({voc}) is "
                    f"smaller than num_samples+1 ({num + 1})"
                )
        if reasons:
            if mode == "always":
                raise ValueError(
                    "tpu.on_device_sampling=always is not applicable here: "
                    + "; ".join(reasons)
                )
            return False
        self.config.log(
            "Sampling negatives on device (host ships positive indices "
            "only)."
        )
        return True

    def _expand_device_batch(self, batch):
        """A batch of positions (``pos_idx``, ``size``): its triples from
        the device pool, its weights (the tail's padding is a suffix) and,
        per active slot, a shared sample drawn on the device in the
        factored form of the fused loss."""
        if "pos_idx" not in batch:
            return batch
        triples = self._device_pool.index_select(0, batch["pos_idx"])
        rows = triples.shape[0]
        weights = (torch.arange(rows, device=triples.device)
                   < batch["size"]).to(torch.float32)
        out = {"triples": triples, "weights": weights, "size": batch["size"]}
        naive = self._sampler.shared_type == "naive"
        for slot in SLOTS:
            num = int(self._sampler.num_samples[slot])
            if num <= 0:
                continue
            unique, base, nu, drop = device_shared_sample(
                self._sampling_gen, num,
                int(self._sampler.vocabulary_size[slot]), naive,
                bool(self._sampler.with_replacement), triples[:, slot])
            key = SLOT_STR[slot]
            out[f"neg_unique_{key}"] = unique
            out[f"neg_base_{key}"] = base
            out[f"neg_nu_{key}"] = nu
            if drop is not None:
                out[f"neg_drop_{key}"] = drop
        return out

    def _on_device_epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's shuffled positions for on-device sampling, with the
        train split staged on the device: the host path's draws in its
        order, so the positives are the host-sampled run's."""
        rng = self._epoch_np_rng(epoch)
        if self._np_seed >= 0:
            self._sampler.seed((self._np_seed + 1, epoch))
        pool = self.dataset.split(self.train_split)
        if self._device_pool is None:
            self._device_pool = torch.from_numpy(
                pool.astype(np.int64)).to(self.device)
        return rng.permutation(len(pool))[: self.num_examples]

    def _epoch_device_payload(self, epoch: int):
        """The whole epoch for device-resident grouped dispatch: [M, B]
        positions and [M] true sizes."""
        if not self._on_device_sampling:
            return None
        idxs, sizes = [], []
        for idx, _, true in self._pad_batch_indexes(
                self._on_device_epoch_order(epoch)):
            idxs.append(idx.astype(np.int32))
            sizes.append(true)
        return {"pos_idx": np.stack(idxs),
                "size": np.asarray(sizes, dtype=np.float32)}

    # ------------------------------------------------------------------ batches

    def _generate_batches(self, epoch: int):
        if self._on_device_sampling:
            for idx, _, true in self._pad_batch_indexes(
                    self._on_device_epoch_order(epoch)):
                yield {"pos_idx": idx.astype(np.int32),
                       "size": np.float32(true)}
            return
        rng = self._epoch_np_rng(epoch)
        if self._np_seed >= 0:
            # negatives re-derive per epoch too (see _epoch_np_rng): a
            # resume at epoch k draws the uninterrupted run's corruptions
            self._sampler.seed((self._np_seed + 1, epoch))
        if self.graph_sampling:
            triples_pool = self._sample_graph(rng)
        else:
            triples_pool = self.dataset.split(self.train_split)
        order = rng.permutation(len(triples_pool))[: self.num_examples]
        for idx, weights, true in self._pad_batch_indexes(order):
            triples = triples_pool[idx].astype(np.int32)
            batch: Dict[str, Any] = {
                "triples": triples,
                "weights": weights,
                "size": np.float32(true),
            }
            for slot in SLOTS:
                if self._sampler.num_samples[slot] <= 0:
                    continue
                ns = self._sampler.sample(triples, slot)
                key = SLOT_STR[slot]
                if ns.shared:
                    batch[f"neg_unique_{key}"] = ns.unique
                    if slot in self._fused_slots:
                        # ship the count FACTORS ([num+1] base vector and
                        # the per-row dropped position); expand_counts
                        # forms the [B, num+1] matrix on the device
                        base, drop = ns.count_factors()
                        batch[f"neg_base_{key}"] = base
                        batch[f"neg_nu_{key}"] = np.int32(ns.num_unique)
                        if drop is not None:
                            batch[f"neg_drop_{key}"] = drop.astype(np.int32)
                    else:
                        batch[f"neg_gather_{key}"] = ns.gather
                else:
                    batch[f"negatives_{key}"] = ns.materialize()
            if self._sparse_paths:
                self._add_row_index_payload(batch)
            yield batch

    def _add_row_index_payload(self, batch: Dict[str, Any]):
        """Host-side uniquify + remap for row-sparse updates: the sorted
        unique ids ``uniq_e`` / ``uniq_r`` the batch touches, and its
        indexes remapped to positions in them, so the step does only
        gathers and row updates."""
        e_pad = self.model.get_s_embedder().padded_vocab_size
        r_pad = self.model.get_p_embedder().padded_vocab_size
        ent_rows, rel_rows = self._touched_row_counts()
        u_e, u_r = min(ent_rows, e_pad), min(rel_rows, r_pad)
        triples = batch["triples"]
        ent_parts = [triples[:, S], triples[:, O]]
        rel_parts = [triples[:, P]]
        for slot in SLOTS:
            if self._sampler.num_samples[slot] <= 0:
                continue
            key = SLOT_STR[slot]
            arr = batch.get(f"neg_unique_{key}",
                            batch.get(f"negatives_{key}"))
            (rel_parts if slot == P else ent_parts).append(arr.reshape(-1))

        def uniquify(parts, size, vocab_pad):
            """Sorted id vector of exactly ``size`` DISTINCT in-range
            ids: the batch's real unique ids plus fill ids drawn from the
            top of the (padded) vocabulary, skipping real ids. Fill rows
            are never referenced by the remapped batch, so their
            gradients are exactly zero and the row update leaves them
            as they are (a fixed shape per step)."""
            uniq = np.unique(np.concatenate(parts))
            if len(uniq) > size:
                raise AssertionError(
                    f"touched-row bound {size} below actual {len(uniq)} "
                    "(bug in _touched_row_counts)"
                )
            if len(uniq) < size:
                n = size - len(uniq)
                window = np.arange(max(vocab_pad - size - n, 0),
                                   vocab_pad, dtype=uniq.dtype)
                fill = np.setdiff1d(window, uniq)[-n:]
                uniq = np.sort(np.concatenate([uniq, fill]))
            return uniq.astype(np.int32)

        uniq_e = uniquify(ent_parts, u_e, e_pad)
        uniq_r = uniquify(rel_parts, u_r, r_pad)
        # uniq is strictly unique, so side='left' and side='right' - 1
        # agree; 'right' puts a run's gradient on its LAST position should
        # duplicates ever appear, which the row-update kernel relies on
        remap_e = lambda a: (
            np.searchsorted(uniq_e, a, side="right") - 1
        ).astype(np.int32)
        remap_r = lambda a: (
            np.searchsorted(uniq_r, a, side="right") - 1
        ).astype(np.int32)
        batch["triples"] = np.stack(
            [remap_e(triples[:, S]), remap_r(triples[:, P]),
             remap_e(triples[:, O])], axis=1,
        )
        for slot in SLOTS:
            if self._sampler.num_samples[slot] <= 0:
                continue
            key = SLOT_STR[slot]
            remap = remap_r if slot == P else remap_e
            if f"neg_unique_{key}" in batch:
                batch[f"neg_unique_{key}"] = remap(batch[f"neg_unique_{key}"])
            else:
                batch[f"negatives_{key}"] = remap(batch[f"negatives_{key}"])
        batch["uniq_e"] = uniq_e
        batch["uniq_r"] = uniq_r

    # ------------------------------------------------------------------ fused loss

    def _fused_loss(self, ctx: Ctx, triples, weights, batch, sl, slots
                    ) -> torch.Tensor:
        model = self.model
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
        q_sp, q_po = model.dot_queries(s, p, o, ctx=ctx)
        total = 0.0
        for slot in slots:
            key = SLOT_STR[slot]
            unique = batch[f"neg_unique_{key}"]        # [num+1]
            drop = batch.get(f"neg_drop_{key}")
            counts = expand_counts(
                batch[f"neg_base_{key}"], batch[f"neg_nu_{key}"],
                None if drop is None else drop[sl], triples.shape[0],
            )
            if slot == O:
                q = q_sp
                cand, _ = model.dot_candidates(unique, ctx=ctx, sides=("sp",))
                pos_cand, _ = model.dot_candidates(o, ctx=ctx, sides=("sp",))
            else:
                q = q_po
                _, cand = model.dot_candidates(unique, ctx=ctx, sides=("po",))
                _, pos_cand = model.dot_candidates(s, ctx=ctx, sides=("po",))
            pos = torch.sum(q * pos_cand, dim=1)
            # the kernel reads row-major operands (CP's candidates are a
            # column slice of the rows, the Transformer's queries a
            # strided slice of its encoder output)
            total = total + shared_ce_loss(q.contiguous(), cand.contiguous(),
                                           pos, counts, weights)
        return total

    # ------------------------------------------------------------------ scoring

    def _negative_scores(self, ctx: Ctx, triples, batch, sl,
                         slot: int) -> torch.Tensor:
        """[rows, num_samples] scores of the sampled corruptions."""
        model = self.model
        key = SLOT_STR[slot]
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]

        def score(subset):
            if slot == S:
                return model.score_po(p, o, s_subset=subset, ctx=ctx)
            if slot == O:
                return model.score_sp(s, p, o_subset=subset, ctx=ctx)
            return model.score_so(s, o, p_subset=subset, ctx=ctx)

        if f"neg_unique_{key}" in batch:
            all_scores = score(batch[f"neg_unique_{key}"])   # [rows, num+1]
            return row_gather(all_scores, batch[f"neg_gather_{key}"][sl])
        negatives = batch[f"negatives_{key}"][sl]             # [rows, num]
        rows, num = negatives.shape
        if self._implementation == "triple":
            flat = negatives.reshape(-1)
            rep = lambda x: torch.repeat_interleave(x, num)
            spo = {S: (flat, rep(p), rep(o)), P: (rep(s), flat, rep(o)),
                   O: (rep(s), rep(p), flat)}[slot]
            return model.score_spo(*spo, direction=key,
                                   ctx=ctx).reshape(rows, num)
        if self._implementation == "all":
            return row_gather(score(None), negatives)         # of [rows, V]
        # batch: score the flattened sample of this subbatch
        all_scores = score(negatives.reshape(-1))             # [rows, rows*num]
        cols = (
            torch.arange(rows, device=negatives.device)[:, None] * num
            + torch.arange(num, device=negatives.device)[None, :]
        )
        return row_gather(all_scores, cols)

    def _subbatch_loss(self, ctx: Ctx, batch, sl):
        for key, value in batch.items():
            if key.startswith("neg_unique_"):
                ctx.mark_replicated(value)  # one shared sample, every rank
        triples = batch["triples"][sl]
        weights = batch["weights"][sl]
        size = batch["size"]
        total = 0.0
        fused = tuple(
            s for s in self._fused_slots
            if f"neg_base_{SLOT_STR[s]}" in batch
        )
        if fused:
            total = total + self._fused_loss(
                ctx, triples, weights, batch, sl, fused
            ) / size
        for slot in SLOTS:
            num = int(self._sampler.num_samples[slot])
            if num <= 0 or slot in fused:
                continue
            pos = self.model.score_spo(
                triples[:, 0], triples[:, 1], triples[:, 2],
                direction=SLOT_STR[slot], ctx=ctx,
            )
            neg = self._negative_scores(ctx, triples, batch, sl, slot)
            scores = torch.cat([pos[:, None], neg], dim=1)
            labels = torch.zeros(scores.shape[0], dtype=torch.long,
                                 device=scores.device)
            total = total + self.loss(
                scores, labels, row_weights=weights, num_negatives=num
            ) / size
        return total
