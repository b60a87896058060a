"""Negative-sampling training (counterpart of
``kge_tpu/train/train_negative_sampling.py``; reference:
kge/job/train_negative_sampling.py).

Per slot with num_samples > 0, scores are arranged [B, 1+num] (the
positive in column 0, the reference layout) and fed to the loss. Ported
is the ``batch`` scoring implementation: shared negatives score the
batch's unique sample once ([B, num+1]) and gather each row's columns;
non-shared negatives score the flattened sample of the subbatch and
gather each row's block.

With shared negatives and the ``kl`` loss, the slots s and o can take
the fused loss instead (``tpu.fused_negsamp_loss``): the scores, the
count-weighted logsumexp and the loss of a slot in one call of
``ops.negsamp_loss.shared_ce_loss``, the hand-written CUDA kernel on a
card. The batch then ships the count factors of its shared sample, which
expand to per-row multiplicities on the device.

Not yet ported (they raise): the ``triple`` and ``all`` implementations,
graph sampling, ``tpu.sparse_updates: always`` (row-sparse updates) and
``tpu.on_device_sampling: always``. Under ``auto`` the port samples on
the host, and where ``kge_tpu`` would update rows sparsely it updates
the tables densely: those rules admit only runs whose every update is
row-local, so dense Adagrad gives the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from kge_tpu_torch.models import Ctx
from kge_tpu_torch.ops.gather import row_gather
from kge_tpu_torch.ops.negsamp_loss import expand_counts, shared_ce_loss
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.sampler import SLOT_STR, SLOTS, KgeSampler, S, P, O
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.seed import rng_seed_from_config


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
        if not forward_only:
            self._resolve_sparse_updates()
        if self.__class__ == TrainingJobNegativeSampling:
            for f in Job.job_created_hooks:
                f(self)

    # ------------------------------------------------------------------ options

    def _resolve_sparse_updates(self):
        """``tpu.sparse_updates``: ``always`` raises (not yet ported);
        under ``auto``, where ``kge_tpu`` would turn row-sparse updates on
        (``_sparse_table_paths`` there), log that the port updates
        densely."""
        config = self.config
        aliases = {True: "always", False: "never", "on": "always",
                   "off": "never"}
        raw = config.get("tpu.sparse_updates")
        if raw in aliases:
            config.set("tpu.sparse_updates", aliases[raw], log=True)
        mode = config.check("tpu.sparse_updates", ["auto", "always", "never"])
        if mode == "always":
            raise NotImplementedError(
                "tpu.sparse_updates always (row-sparse updates) is not yet "
                "ported to kge_tpu_torch"
            )
        if mode == "auto" and not self._sparse_unsupported_reasons():
            config.log(
                "Row-sparse updates are not yet ported to kge_tpu_torch; "
                "updating the tables densely (the same numbers)."
            )

    def _sparse_unsupported_reasons(self) -> List[str]:
        """Why ``kge_tpu`` would keep dense updates here (its rules for
        the models the port has)."""
        config = self.config
        reasons = []
        opt_type = config.get("train.optimizer.default.type").lower()
        if opt_type not in ("adagrad", "sgd"):
            reasons.append(f"optimizer type {opt_type}")
        for name in config.get("train.optimizer").keys():
            args = dict(config.get(f"train.optimizer.{name}.args") or {})
            if args.get("weight_decay", 0.0):
                reasons.append("weight_decay")
            if opt_type == "sgd" and args.get("momentum", 0.0):
                reasons.append("SGD momentum")
        if config.get("train.subbatch_size") > 0:
            reasons.append("subbatch gradient accumulation")
        if config.get("negative_sampling.implementation") == "all":
            reasons.append("implementation 'all'")
        for emb in (self.model.get_s_embedder(), self.model.get_p_embedder()):
            if emb.normalize_p > 0:
                reasons.append("Lp-normalized table")
            if (emb.regularize
                    and emb.get_option("regularize_weight") != 0.0
                    and not emb.get_option("regularize_args.weighted")):
                reasons.append("unweighted regularization")
        if not reasons:
            ent_rows, _ = self._touched_row_counts()
            if self.dataset.num_entities() < 32 * ent_rows:
                reasons.append("entity vocabulary too small")
        return reasons

    def _touched_row_counts(self):
        """Static (entity, relation) bounds on rows touched per batch."""
        batch_size = self.batch_size
        shared = self._sampler.shared
        ent_rows, rel_rows = 2 * batch_size, batch_size
        for slot in SLOTS:
            n = int(self._sampler.num_samples[slot])
            if n <= 0:
                continue
            extra = n + 1 if shared else batch_size * n
            if slot == P:
                rel_rows += extra
            else:
                ent_rows += extra
        return ent_rows, rel_rows

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
        if self._implementation != "batch":
            raise NotImplementedError(
                f"negative_sampling.implementation {self._implementation} is "
                "not yet ported to kge_tpu_torch (batch is)"
            )
        self.config.log(
            f"Preparing negative sampling with '{self._implementation}' "
            "scoring..."
        )
        self._fused_slots = self._resolve_fused_loss_slots()
        graph_sampling = self.config.check(
            "negative_sampling.graph_sampling",
            ["uniform", "edge_neighbourhood", "None"],
        )
        if graph_sampling != "None":
            raise NotImplementedError(
                "negative_sampling.graph_sampling is not yet ported to "
                "kge_tpu_torch"
            )
        if self.config.check("tpu.on_device_sampling",
                             ["auto", "always", "never"]) == "always":
            raise NotImplementedError(
                "tpu.on_device_sampling always is not yet ported to "
                "kge_tpu_torch (negatives are sampled on the host)"
            )
        self.num_examples = len(self.dataset.split(self.train_split))

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

    # ------------------------------------------------------------------ batches

    def _generate_batches(self, epoch: int):
        rng = self._epoch_np_rng(epoch)
        if self._np_seed >= 0:
            # negatives re-derive per epoch too (see _epoch_np_rng): a
            # resume at epoch k draws the uninterrupted run's corruptions
            self._sampler.seed((self._np_seed + 1, epoch))
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
            yield batch

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
            total = total + shared_ce_loss(q, cand, pos, counts, weights)
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
        # not shared: score the flattened sample of this subbatch
        negatives = batch[f"negatives_{key}"][sl]             # [rows, num]
        rows, num = negatives.shape
        all_scores = score(negatives.reshape(-1))             # [rows, rows*num]
        cols = (
            torch.arange(rows, device=negatives.device)[:, None] * num
            + torch.arange(num, device=negatives.device)[None, :]
        )
        return row_gather(all_scores, cols)

    def _subbatch_loss(self, ctx: Ctx, batch, sl):
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
