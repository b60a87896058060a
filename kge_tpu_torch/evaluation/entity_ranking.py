"""Entity-ranking evaluation: filtered MRR / Hits@K via rank counting
(counterpart of ``kge_tpu/evaluation/entity_ranking.py``; reference:
kge/job/eval_entity_ranking.py).

Ranking by *comparison counting* — rank = #(scores > true), ties =
#(scores ≈ true) — needs no sort and no top-k. The fused path scores
every batch against the whole entity table with one launch of the
rank-count kernel per side (``ops/rank_count.py``) and filters by
subtracting the counts of the label coordinates.

Reference semantics preserved:
- filtering removes true answers from the competition
- tie detection with rtol/atol against the true score; tie policies
  rounded_mean/best/worst (eval_entity_ranking.py:571-618)
- rank histograms (length E) -> MR / MRR / Hits@K for raw / filtered /
  filtered_with_test, plus head/tail, relation-type, and frequency
  drill-downs (eval_entity_ranking.py:620-741)
- true scores are computed through the same sp_/_po scoring path as the
  reference (floating-point-consistency trick,
  eval_entity_ranking.py:186-203), with an spo-vs-sp_ consistency check

Scoring is float32 throughout: TF32 is switched off for the run, since
it would move scores across the tie tolerance and change the counts.
Not ported yet: ``entity_ranking.implementation: generic`` (chunked
score_sp_po with -inf masking, for models without a dot form) and the
vocabulary-sharded multi-device form.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.models import Ctx
from kge_tpu_torch.ops.rank_count import greater_tie_counts, rank_counts
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.misc import pow2_bucket as _bucket


def _pad_to(a: np.ndarray, width: int) -> np.ndarray:
    if a.shape[1] == width:
        return a
    out = np.full((a.shape[0], width), 2 ** 30, dtype=np.int32)
    out[:, : a.shape[1]] = a
    return out


class EntityRankingJob(EvaluationJob):
    def __init__(self, config, dataset, parent_job=None, model=None):
        super().__init__(config, dataset, parent_job, model=model)
        self.config.check("train.trace_level", ["epoch", "batch"])
        # copy: Config.get returns leaf lists by reference, and appending
        # in place would leak the eval split into the shared Config
        self.filter_splits: List[str] = list(self.config.get(
            "entity_ranking.filter_splits"
        ))
        if self.eval_split not in self.filter_splits:
            self.filter_splits.append(self.eval_split)
        self.filter_with_test: bool = self.config.get(
            "entity_ranking.filter_with_test"
        )
        self.tie_handling: str = self.config.check(
            "entity_ranking.tie_handling.type",
            ["rounded_mean_rank", "best_rank", "worst_rank"],
        )
        self.tie_atol = float(self.config.get("entity_ranking.tie_handling.atol"))
        self.tie_rtol = float(self.config.get("entity_ranking.tie_handling.rtol"))
        self.tie_warn_only = self.config.get(
            "entity_ranking.tie_handling.warn_only"
        )
        self.hits_at_k_s: List[int] = self.config.get("entity_ranking.hits_at_k_s")
        self.head_and_tail = self.config.get(
            "entity_ranking.metrics_per.head_and_tail"
        )
        self.hist_hooks = [hist_all]
        if self.config.get("entity_ranking.metrics_per.relation_type"):
            self.hist_hooks.append(hist_per_relation_type)
        if self.config.get("entity_ranking.metrics_per.argument_frequency"):
            self.hist_hooks.append(hist_per_frequency_percentile)
        implementation = self.config.check(
            "entity_ranking.implementation", ["auto", "generic", "fused"]
        )
        if implementation == "generic" or (
            implementation == "auto" and not self.model.supports_dot_ranking()
        ):
            raise NotImplementedError(
                "entity_ranking.implementation generic (models without a dot "
                "form) is not yet ported to kge_tpu_torch"
            )
        if self.model.dot_score_space() != "native":
            # a monotone dot form needs the true scores from the dot path
            # (kge_tpu/evaluation/entity_ranking.py:402-416)
            raise NotImplementedError(
                "ranking in a monotone dot score space is not yet ported"
            )
        if self.__class__ == EntityRankingJob:
            for f in Job.job_created_hooks:
                f(self)

    def _prepare(self):
        self.triples = self.dataset.split(self.eval_split)
        # label indexes for filtering
        for split in self.filter_splits:
            self.dataset.index(f"{split}_sp_to_o")
            self.dataset.index(f"{split}_po_to_s")
        if "test" not in self.filter_splits and self.filter_with_test:
            self.dataset.index("test_sp_to_o")
            self.dataset.index("test_po_to_s")
        if self.config.get("entity_ranking.metrics_per.relation_type"):
            self.dataset.index("relations_per_type")
        if self.config.get("entity_ranking.metrics_per.argument_frequency"):
            self.dataset.index("frequency_percentiles")

    # ------------------------------------------------------------------ coords

    def _collect_coords(self, triples: np.ndarray, splits: List[str]):
        """Per-row answer sets from the given splits, as padded arrays.

        Returns (sp_coords [B, Lo], po_coords [B, Ls]) of *global* entity
        ids; padding value 2^30 (always out of chunk range)."""
        B = len(triples)
        sp_rows, sp_vals, po_rows, po_vals = [], [], [], []
        for split in splits:
            sp_index = self.dataset.index(f"{split}_sp_to_o")
            po_index = self.dataset.index(f"{split}_po_to_s")
            r, v = sp_index.get_all_coords(triples[:, [0, 1]])
            sp_rows.append(r)
            sp_vals.append(v)
            r, v = po_index.get_all_coords(triples[:, [1, 2]])
            po_rows.append(r)
            po_vals.append(v)

        def pad(rows_list, vals_list, self_vals):
            rows = np.concatenate(rows_list) if rows_list else np.zeros(0, int)
            vals = np.concatenate(vals_list) if vals_list else np.zeros(0, int)
            # dedupe (row, val) pairs: splits can repeat answers, and the
            # fused path subtracts per coordinate
            if len(rows):
                enc = rows.astype(np.int64) * (2 ** 31) + vals
                enc = np.unique(enc)
                rows = (enc // (2 ** 31)).astype(np.int64)
                vals = (enc % (2 ** 31)).astype(np.int64)
                # remove the current example itself: the reference zeroes
                # it out of the label tensor before filtering
                # (eval_entity_ranking.py:287-290), so the true answer
                # keeps its finite score and still counts in the tie set
                keep = vals != self_vals[rows]
                rows, vals = rows[keep], vals[keep]
            counts = np.bincount(rows, minlength=B).astype(np.int64)
            L = _bucket(int(counts.max()) if len(counts) else 1)
            out = np.full((B, L), 2 ** 30, dtype=np.int32)
            col = np.concatenate([np.arange(c) for c in counts if c > 0]) \
                if len(vals) else np.zeros(0, dtype=np.int64)
            out[rows, col] = vals
            return out

        return (
            pad(sp_rows, sp_vals, triples[:, 2].astype(np.int64)),
            pad(po_rows, po_vals, triples[:, 0].astype(np.int64)),
        )

    # ------------------------------------------------------------------ scores

    def _true_scores(self, s, p, o):
        """True scores through the sp_/_po matrix path (the diagonal of
        a [B, B] score block), as ``kge_tpu`` computes them."""
        ctx = Ctx()
        o_true = torch.diagonal(self.model.score_sp(s, p, o_subset=o, ctx=ctx))
        s_true = torch.diagonal(self.model.score_po(p, o, s_subset=s, ctx=ctx))
        return o_true, s_true

    def _spo_scores(self, s, p, o):
        """Device half of the spo-vs-sp_ consistency check: the
        triple-wise scores, compared after the fetch."""
        ctx = Ctx()
        return (self.model.score_spo(s, p, o, direction="o", ctx=ctx),
                self.model.score_spo(s, p, o, direction="s", ctx=ctx))

    def _check_spo_consistency(self, o_spo, s_spo, o_true, s_true):
        """spo-vs-sp_ floating point consistency check (reference:
        eval_entity_ranking.py:240-274): the triple-wise scoring path
        must agree with the matrix path within the tie tolerances."""
        for name, a, b in [("sp_", o_spo, o_true), ("_po", s_spo, s_true)]:
            close = np.isclose(a, b, rtol=self.tie_rtol, atol=self.tie_atol)
            if not close.all():
                diff = float(np.abs(a - b).max())
                msg = (
                    f"spo scores differ from {name} scores beyond the tie "
                    f"tolerances (max abs diff {diff:.3e})"
                )
                if self.tie_warn_only:
                    self.config.log("WARNING: " + msg)
                else:
                    raise ValueError(msg)

    # -------------------------------------------------------------- fused path

    def _fused_counts(self, s, p, o, coords_sp, coords_po, o_true, s_true,
                      num_rankings: int) -> torch.Tensor:
        """[num_rankings, 4, B] int32 (o_rank, o_tie, s_rank, s_tie) per
        ranking variant (0 = raw, then filtered). Dot-form queries; one
        rank-count launch per side over the whole candidate table; and
        filtering by counting: only the label coordinates are scored, and
        their greater/tie contributions are subtracted from the raw
        counts — the same semantics as masking labels to -inf, without a
        [B, E] score matrix."""
        model = self.model
        atol, rtol = self.tie_atol, self.tie_rtol
        num_entities = self.dataset.num_entities()
        ctx = Ctx()
        q_sp, q_po = model.dot_queries(s, p, o, ctx=ctx)
        # NaN -> -inf before counting (the rank kernel's contract) so a
        # NaN-scoring model ranks last instead of first
        o_true = torch.where(torch.isnan(o_true), -torch.inf, o_true)
        s_true = torch.where(torch.isnan(s_true), -torch.inf, s_true)

        # the unpadded tables, read in place by the kernel
        cand_sp, cand_po = model.dot_candidates_all(ctx=ctx)
        valid = torch.ones(cand_sp.shape[0], dtype=torch.float32,
                           device=cand_sp.device)
        r0, t0 = rank_counts(q_sp, cand_sp, o_true, valid, atol, rtol)
        r1, t1 = rank_counts(q_po, cand_po, s_true, valid, atol, rtol)
        raw = torch.stack([r0, t0, r1, t1])

        def coord_counts(q, coords, true, side):
            # coords: [V-1, B, L] global entity ids (2^30 padding)
            label = coords < num_entities
            ids = torch.clamp(coords, max=num_entities - 1)
            cand_sp, cand_po = model.dot_candidates(ids, ctx=ctx,
                                                    sides=(side,))
            cand = cand_sp if side == "sp" else cand_po
            scores = torch.einsum("bd,vbld->vbl", q, cand)
            return greater_tie_counts(scores, true[None, :, None], label,
                                      dim=2, atol=atol, rtol=rtol)

        sp_sub_r, sp_sub_t = coord_counts(q_sp, coords_sp, o_true, "sp")
        po_sub_r, po_sub_t = coord_counts(q_po, coords_po, s_true, "po")
        # Clamp at zero: the label-score einsum and the rank-count kernel
        # can classify a score at the exact tie boundary differently
        # (float noise), and a negative count would crash the host-side
        # histogram bincount. Ties clamp at 1 (the true answer always
        # ties with itself).
        totals = [raw]
        for k in range(num_rankings - 1):
            totals.append(torch.stack([
                torch.clamp(raw[0] - sp_sub_r[k], min=0),
                torch.clamp(raw[1] - sp_sub_t[k], min=1),
                torch.clamp(raw[2] - po_sub_r[k], min=0),
                torch.clamp(raw[3] - po_sub_t[k], min=1),
            ]))
        return torch.stack(totals)

    def _final_ranks(self, rank: np.ndarray, ties: np.ndarray) -> np.ndarray:
        if self.tie_handling == "rounded_mean_rank":
            return rank + ties // 2
        if self.tie_handling == "best_rank":
            return rank
        return rank + np.maximum(ties - 1, 0)

    def _accumulate_batch(self, hists, rankings, totals, batch,
                          example_traces, B):
        """Finalize ranks per variant, update histograms + example traces."""
        s_np, p_np, o_np = batch[:, 0], batch[:, 1], batch[:, 2]
        batch_ranks = {}
        for v, suffix in enumerate(rankings):
            o_rank = self._final_ranks(totals[v, 0], totals[v, 1])
            s_rank = self._final_ranks(totals[v, 2], totals[v, 3])
            batch_ranks[suffix] = (s_rank, o_rank)
            for f in self.hist_hooks:
                f(hists[v], s_np, p_np, o_np, s_rank, o_rank, job=self)
        if self.trace_examples:
            for i in range(B):
                entry = dict(
                    type="entity_ranking", scope="example",
                    split=self.eval_split, epoch=self.epoch,
                    s=int(s_np[i]), p=int(p_np[i]), o=int(o_np[i]),
                )
                for suffix in rankings:
                    s_rank, o_rank = batch_ranks[suffix]
                    entry[f"rank_s{suffix}"] = int(s_rank[i]) + 1
                    entry[f"rank_o{suffix}"] = int(o_rank[i]) + 1
                example_traces.append(entry)

    # ------------------------------------------------------------------ evaluate

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> job device without waiting for queued work (a
        copy from pageable memory would synchronize the stream)."""
        tensor = torch.from_numpy(array)
        if self.device.type == "cuda":
            return tensor.pin_memory().to(self.device, non_blocking=True)
        return tensor

    def _evaluate(self):
        if not self._is_prepared:
            self._prepare()
            self._is_prepared = True
        # exact float32 scores: TF32 would move scores across the tie
        # tolerance and change the counts
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        filter_with_test = (
            "test" not in self.filter_splits and self.filter_with_test
        )
        rankings = ["", "_filtered"] + (
            ["_filtered_with_test"] if filter_with_test else []
        )

        hists: List[Dict[str, np.ndarray]] = [dict() for _ in rankings]
        epoch_time = -time.time()
        self.current_trace["epoch"] = dict(
            type="entity_ranking",
            scope="epoch",
            split=self.eval_split,
            filter_splits=self.filter_splits,
            epoch=self.epoch,
            batches=math.ceil(len(self.triples) / self.batch_size),
            size=len(self.triples),
        )
        for f in self.pre_epoch_hooks:
            f(self)

        # Dispatch phase: every batch's device work is enqueued without a
        # single device->host fetch; results are pulled and post-processed
        # after the last batch is in flight, while the host builds the
        # next batch's label coordinates meanwhile.
        columns = self._upload(
            np.ascontiguousarray(self.triples.T.astype(np.int64))
        )
        example_traces = []
        pending = []
        # Spans (torch.profiler.record_function; no cost without a
        # profiler) name the phases a profile of this loop reads.
        with torch.no_grad():
            for start in range(0, len(self.triples), self.batch_size):
                for f in self.pre_batch_hooks:
                    f(self)
                batch = self.triples[start : start + self.batch_size]
                B = len(batch)
                s, p, o = columns[:, start : start + B]
                with record_function("entity_ranking.true_scores"):
                    o_true, s_true = self._true_scores(s, p, o)
                    o_spo, s_spo = self._spo_scores(s, p, o)

                with record_function("entity_ranking.collect_coords"):
                    # label coordinates per filtered ranking (deduped per
                    # row), padded to a common bucketed width
                    coord_sets = [
                        self._collect_coords(batch, self.filter_splits)
                    ]
                    if filter_with_test:
                        coord_sets.append(self._collect_coords(
                            batch, self.filter_splits + ["test"]
                        ))
                    L = _bucket(max(cs[0].shape[1] for cs in coord_sets))
                    Lp = _bucket(max(cs[1].shape[1] for cs in coord_sets))
                    coords_sp = np.stack([_pad_to(cs[0], L) for cs in coord_sets])
                    coords_po = np.stack([_pad_to(cs[1], Lp) for cs in coord_sets])
                with record_function("entity_ranking.fused_counts"):
                    totals = self._fused_counts(
                        s, p, o, self._upload(coords_sp),
                        self._upload(coords_po), o_true, s_true,
                        len(rankings),
                    )
                pending.append(
                    (batch, totals, torch.stack([o_spo, s_spo, o_true, s_true]))
                )
                for f in self.post_batch_hooks:
                    f(self)

        # Fetch phase: after the last batch is in flight, one transfer per
        # kind of result, for all batches at once.
        if pending:
            with record_function("entity_ranking.fetch"):
                totals = torch.cat([t for _, t, _ in pending], dim=2)
                totals = totals.cpu().numpy().astype(np.int64)
                scores = torch.cat([x for _, _, x in pending], dim=1)
                scores = scores.cpu().numpy()  # o_spo, s_spo, o_true, s_true
            with record_function("entity_ranking.histograms"):
                start = 0
                for batch, _, _ in pending:
                    B = len(batch)
                    part = slice(start, start + B)
                    start += B
                    self._check_spo_consistency(*scores[:, part])
                    self._accumulate_batch(
                        hists, rankings, totals[:, :, part], batch,
                        example_traces, B,
                    )

        for entry in example_traces:
            self.config.trace(**entry)

        # metrics from merged histograms
        metrics: Dict[str, float] = {}
        for key in hists[0].keys():
            name = "_" + key if key != "all" else ""
            for v, suffix in enumerate(rankings):
                metrics.update(
                    self._compute_metrics(hists[v][key], suffix=suffix + name)
                )
        epoch_time += time.time()
        self.current_trace["epoch"].update(
            dict(epoch_time=epoch_time, event="eval_completed", **metrics)
        )
        for f in self.post_epoch_hooks:
            f(self)

    def _compute_metrics(self, rank_hist: np.ndarray, suffix="") -> Dict[str, float]:
        """MR / MRR / Hits@K from a histogram of 0-based ranks
        (reference: eval_entity_ranking.py:620-649)."""
        metrics = {}
        n = float(rank_hist.sum())
        ranks = np.arange(1, len(rank_hist) + 1, dtype=np.float64)
        metrics["mean_rank" + suffix] = (
            float(np.sum(rank_hist * ranks) / n) if n > 0 else 0.0
        )
        metrics["mean_reciprocal_rank" + suffix] = (
            float(np.sum(rank_hist / ranks) / n) if n > 0 else 0.0
        )
        max_k = max(self.hits_at_k_s)
        hits = (
            np.cumsum(rank_hist[: max_k]) / n
            if n > 0 else np.zeros(max_k)
        )
        for k in self.hits_at_k_s:
            metrics[f"hits_at_{k}{suffix}"] = float(hits[min(k, len(hits)) - 1])
        return metrics


# HISTOGRAM HOOKS ###########################################################


def hist_all(hists, s, p, o, s_ranks, o_ranks, job, **kwargs):
    """Overall (and optionally head/tail) histograms of 0-based ranks."""
    E = job.dataset.num_entities()
    if "all" not in hists:
        hists["all"] = np.zeros(E)
    hists["all"] += np.bincount(o_ranks, minlength=E)
    hists["all"] += np.bincount(s_ranks, minlength=E)
    if job.head_and_tail:
        if "head" not in hists:
            hists["head"] = np.zeros(E)
            hists["tail"] = np.zeros(E)
        hists["tail"] += np.bincount(o_ranks, minlength=E)
        hists["head"] += np.bincount(s_ranks, minlength=E)


def _rel_type_lookup(job):
    """Cached relation-id -> type-name membership masks: one id-indexed
    boolean array per type (a relation can carry only one type, but the
    array form keeps per-batch work at one gather instead of per-element
    set membership — minutes at Wikidata scale otherwise)."""
    cached = getattr(job, "_rel_type_masks", None)
    if cached is None:
        R = job.dataset.num_relations()
        cached = {}
        for rel_type, rels in job.dataset.index("relations_per_type").items():
            mask = np.zeros(R, dtype=bool)
            mask[np.fromiter(rels, dtype=np.int64, count=len(rels))] = True
            cached[rel_type] = mask
        job._rel_type_masks = cached
    return cached


def hist_per_relation_type(hists, s, p, o, s_ranks, o_ranks, job, **kwargs):
    E = job.dataset.num_entities()
    for rel_type, rel_mask in _rel_type_lookup(job).items():
        if rel_type not in hists:
            hists[rel_type] = np.zeros(E)
        mask = rel_mask[p]
        if mask.any():
            hists[rel_type] += np.bincount(o_ranks[mask], minlength=E)
            hists[rel_type] += np.bincount(s_ranks[mask], minlength=E)
        if job.head_and_tail:
            for side, ranks in [("head", s_ranks), ("tail", o_ranks)]:
                key = f"{rel_type}_{side}"
                if key not in hists:
                    hists[key] = np.zeros(E)
                if mask.any():
                    hists[key] += np.bincount(ranks[mask], minlength=E)


def _freq_perc_lookup(job):
    """Cached id-indexed membership masks per (argument, percentile)."""
    cached = getattr(job, "_freq_perc_masks", None)
    if cached is None:
        percs = job.dataset.index("frequency_percentiles")
        sizes = {
            "subject": job.dataset.num_entities(),
            "object": job.dataset.num_entities(),
            "relation": job.dataset.num_relations(),
        }
        cached = {}
        for arg, by_perc in percs.items():
            for perc, ids in by_perc.items():
                mask = np.zeros(sizes[arg], dtype=bool)
                if len(ids):
                    mask[np.fromiter(ids, dtype=np.int64, count=len(ids))] \
                        = True
                cached[(arg, perc)] = mask
        job._freq_perc_masks = cached
    return cached


def hist_per_frequency_percentile(hists, s, p, o, s_ranks, o_ranks, job,
                                  **kwargs):
    E = job.dataset.num_entities()
    percs = job.dataset.index("frequency_percentiles")
    lookup = _freq_perc_lookup(job)
    for perc in percs["subject"].keys():
        for arg, ids, ranks in [
            ("subject", s, s_ranks),
            ("relation", p, s_ranks),
            ("object", o, o_ranks),
        ]:
            key = f"{arg}_{perc}"
            if key not in hists:
                hists[key] = np.zeros(E)
            mask = lookup[(arg, perc)][ids]
            if mask.any():
                hists[key] += np.bincount(ranks[mask], minlength=E)
        # relation percentile also counts object ranks
        key = f"relation_{perc}"
        mask = lookup[("relation", perc)][p]
        if mask.any():
            hists[key] += np.bincount(o_ranks[mask], minlength=E)
