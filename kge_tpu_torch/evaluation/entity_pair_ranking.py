"""Entity-pair ranking evaluation (counterpart of
``kge_tpu/evaluation/entity_pair_ranking.py``; the reference registers
the job type without implementing it, kge/job/eval_entity_pair_ranking.py).

For each test triple (s, p, o) the true pair (s, o) is ranked against all
entity pairs (s', o') scored under p; the metrics are mean_rank,
mean_reciprocal_rank and hits_at_k, raw and filtered (the true pairs of p
in the filter splits removed). As in ``kge_tpu`` the ranks are greater
and tie counts (``ops.rank_count.greater_tie_counts``), never sorts:

- queries go in batches; each batch scores its [bq * chunk, E] blocks
  with ``score_sp``, one subject chunk after another, and the counts add
  up on the device;
- filtering subtracts the counts over each query's true-pair list, scored
  with ``score_spo`` in a second batched call;
- every count comes back in one transfer at the end.

``kge_tpu`` has no Pallas kernel here, so this is plain torch. The
protocol is quadratic in the entity count: it is for analysis on small
and medium graphs (E at most 65,535, as in ``kge_tpu``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.ops.rank_count import greater_tie_counts
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.misc import pow2_bucket as _bucket


class EntityPairRankingJob(EvaluationJob):
    def __init__(self, config, dataset, parent_job=None, model=None):
        super().__init__(config, dataset, parent_job, model=model)
        self.chunk_size = config.get("entity_pair_ranking.chunk_size")
        self.hits_at_k_s = list(config.get("entity_ranking.hits_at_k_s"))
        self.tie_atol = float(config.get("entity_ranking.tie_handling.atol"))
        self.tie_rtol = float(config.get("entity_ranking.tie_handling.rtol"))
        self.tie_handling = config.check(
            "entity_ranking.tie_handling.type",
            ["rounded_mean_rank", "best_rank", "worst_rank"],
        )
        self.filter_splits = list(
            config.get("entity_ranking.filter_splits") or ["train", "valid"]
        )
        if self.eval_split not in self.filter_splits:
            self.filter_splits = self.filter_splits + [self.eval_split]
        self.triples = None
        self._pairs_by_p = None
        if self.__class__ == EntityPairRankingJob:
            for f in Job.job_created_hooks:
                f(self)

    # ------------------------------------------------------------------ counts

    def _batch_counts(self, p_batch, true_scores, chunk: int, ctx):
        """Greater and tie counts [bq] of each query's true score among
        all E x E pairs under its relation, subject chunk by chunk."""
        E = self.dataset.num_entities()
        bq = p_batch.shape[0]
        device = p_batch.device
        greater = torch.zeros(bq, dtype=torch.int64, device=device)
        ties = torch.zeros(bq, dtype=torch.int64, device=device)
        p_rep = torch.repeat_interleave(p_batch, chunk)
        for start in range(0, E, chunk):
            ids = torch.arange(start, start + chunk, device=device)
            valid = ids < E
            s_rep = torch.where(valid, ids, 0).repeat(bq)
            scores = self.model.score_sp(s_rep, p_rep, ctx=ctx)
            g, t = greater_tie_counts(
                scores.reshape(bq, chunk, -1), true_scores[:, None, None],
                valid[None, :, None], dim=(1, 2),
                atol=self.tie_atol, rtol=self.tie_rtol)
            greater += g
            ties += t
        return greater, ties

    def _filter_counts(self, s_ids, p_batch, o_ids, fvalid, true_scores,
                       ctx):
        """Counts over each query's true-pair list ([bq, L] coordinates),
        scored directly with ``score_spo``."""
        bq, L = s_ids.shape
        scores = self.model.score_spo(
            s_ids.reshape(-1), torch.repeat_interleave(p_batch, L),
            o_ids.reshape(-1), direction="o", ctx=ctx).reshape(bq, L)
        return greater_tie_counts(scores, true_scores[:, None], fvalid,
                                  dim=1, atol=self.tie_atol,
                                  rtol=self.tie_rtol)

    def _true_pairs(self, E: int) -> Dict[int, set]:
        """The encoded (s * E + o) true pairs of each relation over the
        filter splits, built once a job."""
        if self._pairs_by_p is None:
            pairs_by_p: Dict[int, set] = {}
            for split in self.filter_splits:
                tr = np.asarray(self.dataset.split(split))
                if not len(tr):
                    continue
                enc = tr[:, 0].astype(np.int64) * E + tr[:, 2].astype(np.int64)
                order = np.argsort(tr[:, 1], kind="stable")
                ps, starts = np.unique(tr[order, 1], return_index=True)
                enc_sorted = enc[order]
                bounds = list(starts[1:]) + [len(enc_sorted)]
                for p, lo, hi in zip(ps, starts, bounds):
                    pairs_by_p.setdefault(int(p), set()).update(
                        enc_sorted[lo:hi].tolist())
            self._pairs_by_p = pairs_by_p
        return self._pairs_by_p

    # ------------------------------------------------------------------ evaluate

    @torch.no_grad()
    def _evaluate(self):
        if self.triples is None:
            self.triples = self.dataset.split(self.eval_split)
        E = self.dataset.num_entities()
        if E > 65535:
            raise ValueError(
                "entity_pair_ranking ranks every query against E^2 "
                f"entity pairs; E={E} exceeds both the 32-bit count "
                "range and the practical cost of the quadratic protocol "
                "(intended for small/medium analysis graphs)"
            )
        chunk = self.chunk_size if self.chunk_size > 0 else E
        # honor eval.batch_size, but keep each [bq, chunk, E] score block
        # under 256 MiB of float32
        bq = max(1, min(int(self.batch_size),
                        (64 << 20) // max(chunk * E, 1)))
        pairs_by_p = self._true_pairs(E)

        epoch_time = -time.time()
        self.current_trace["epoch"] = dict(
            type="entity_pair_ranking", scope="epoch", split=self.eval_split,
            filter_splits=self.filter_splits, epoch=self.epoch,
            size=len(self.triples),
        )
        for f in self.pre_epoch_hooks:
            f(self)

        ctx = self.model.default_ctx()
        device = self.device
        triples = np.asarray(self.triples)
        pending = []
        for start in range(0, len(triples), bq):
            batch = triples[start:start + bq]
            n = len(batch)
            spo = np.zeros((3, bq), np.int64)
            spo[:, :n] = batch.T
            s_b, p_b, o_b = torch.as_tensor(spo, device=device)
            true_scores = self.model.score_spo(s_b, p_b, o_b, direction="o",
                                               ctx=ctx)
            # padded query rows rank against true = +inf: zero counts
            true_scores[n:] = torch.inf
            g, t = self._batch_counts(p_b, true_scores, chunk, ctx)

            # filtered: each query's true pairs of p but its own
            encs = [
                sorted(pairs_by_p.get(int(p), set()) - {int(s) * E + int(o)})
                for s, p, o in batch
            ]
            L = _bucket(max((len(e) for e in encs), default=0) or 1)
            coords = np.zeros((2, bq, L), np.int64)
            fvalid = np.zeros((bq, L), bool)
            for i, enc in enumerate(encs):
                enc = np.asarray(enc, dtype=np.int64)
                coords[:, i, : len(enc)] = enc // E, enc % E
                fvalid[i, : len(enc)] = True
            s_ids, o_ids = torch.as_tensor(coords, device=device)
            fg, ft = self._filter_counts(
                s_ids, p_b, o_ids, torch.as_tensor(fvalid, device=device),
                true_scores, ctx)
            pending.append(torch.stack(
                [g, t, fg.long(), ft.long()])[:, :n])

        # one transfer, then the host's rank arithmetic
        counts = (torch.cat(pending, dim=1).cpu().numpy() if pending
                  else np.zeros((4, 0), np.int64))
        ranks: List[Dict[str, int]] = []
        for g_raw, t_raw, fg, ft in counts.T.tolist():
            # clamp: the chunked score_sp path and the score_spo path can
            # disagree within float noise; the filtered counts never drop
            # below the true pair itself
            g_f = max(g_raw - fg, 0)
            t_f = max(t_raw - ft, 1)
            ranks.append({
                "rank": self._final_rank(g_raw, t_raw),
                "rank_filtered": self._final_rank(g_f, t_f),
            })

        metrics: Dict[str, float] = {}
        for suffix, key in (("", "rank"), ("_filtered", "rank_filtered")):
            rs = np.asarray([r[key] for r in ranks], dtype=np.float64) + 1.0
            metrics["mean_rank" + suffix] = float(rs.mean()) if len(rs) else 0.0
            metrics["mean_reciprocal_rank" + suffix] = (
                float((1.0 / rs).mean()) if len(rs) else 0.0
            )
            for k in self.hits_at_k_s:
                metrics[f"hits_at_{k}{suffix}"] = (
                    float((rs <= k).mean()) if len(rs) else 0.0
                )
        epoch_time += time.time()
        self.current_trace["epoch"].update(
            dict(epoch_time=epoch_time, event="eval_completed", **metrics)
        )
        for f in self.post_epoch_hooks:
            f(self)

    def _final_rank(self, greater: int, ties: int) -> int:
        # ties include the true pair itself, as in entity ranking
        ties_excl = max(ties - 1, 0)
        if self.tie_handling == "rounded_mean_rank":
            return greater + (ties_excl + 1) // 2
        if self.tie_handling == "best_rank":
            return greater
        return greater + ties_excl
