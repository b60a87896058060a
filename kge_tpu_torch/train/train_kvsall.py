"""KvsAll training (counterpart of ``kge_tpu/train/train_kvsall.py``;
reference: kge/job/train_KvsAll.py): unique queries scored against all
candidates with multi-label targets.

The batches are ``kge_tpu``'s, array for array: each holds queries of one
type (``sp_``, ``_po``, ``s_o``), with their answers as label coordinates
padded to a power-of-two width with the out-of-range value
``num_candidates``; with ``tpu.steps_per_dispatch`` > 1 the epoch's
batches are regrouped into runs of one (type, width), as ``kge_tpu``
orders them for its grouped dispatch, and each run dispatches as a
group (a CUDA graph on a card, ``train.py``). The step adds the coordinates into
a [B, N + 1] label buffer and drops its last column, so the padding
never lands in a label.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from kge_tpu_torch.models import Ctx
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.misc import pow2_bucket

QTYPES = ["sp_", "_po", "s_o"]
QTYPE_KEYS = {"sp_": "qtype_sp", "_po": "qtype_po", "s_o": "qtype_so"}
QTYPE_INDEX = {"sp_": "sp_to_o", "_po": "po_to_s", "s_o": "so_to_p"}


class TrainingJobKvsAll(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        config.log("Initializing KvsAll training job...")
        self.type_str = "KvsAll"
        self.label_smoothing = config.check_range(
            "KvsAll.label_smoothing", float("-inf"), 1.0, max_inclusive=False
        )
        if self.label_smoothing < 0:
            if config.get("train.auto_correct"):
                config.log(
                    "Setting KvsAll.label_smoothing to 0 "
                    f"(was {self.label_smoothing})."
                )
                self.label_smoothing = 0.0
            else:
                raise ValueError("KvsAll.label_smoothing must be >= 0")
        if self.label_smoothing > 0 and self.label_smoothing <= (
            1.0 / dataset.num_entities()
        ):
            if config.get("train.auto_correct"):
                self.label_smoothing = 1.0 / dataset.num_entities() + 1e-9
                config.log(
                    "Raised KvsAll.label_smoothing to "
                    f"{self.label_smoothing}."
                )
            else:
                raise ValueError(
                    "KvsAll.label_smoothing must exceed 1/num_entities"
                )
        if self.__class__ == TrainingJobKvsAll:
            for f in Job.job_created_hooks:
                f(self)

    def _prepare(self):
        self.query_types = [
            qt for qt in QTYPES
            if self.config.get(f"KvsAll.query_types.{qt}")
        ]
        if not self.query_types:
            raise ValueError("no enabled query types for KvsAll")
        self.indexes = {}
        self.queries = {}
        num = 0
        for qt in self.query_types:
            index = self.dataset.index(
                f"{self.train_split}_{QTYPE_INDEX[qt]}"
            )
            self.indexes[qt] = index
            self.queries[qt] = index.keys
            num += len(index.keys)
        self.num_examples = num

    def _num_candidates(self, qt: str) -> int:
        return (
            self.dataset.num_relations() if qt == "s_o"
            else self.dataset.num_entities()
        )

    def _generate_batches(self, epoch: int):
        # batches of one query type, shuffled across types
        rng = self._epoch_np_rng(epoch)
        batches = []
        for qt in self.query_types:
            order = rng.permutation(len(self.queries[qt]))
            for idx, weights, true in self._pad_batch_indexes(order):
                batches.append((qt, idx, weights, true, None))
        rng.shuffle(batches)
        group = self._steps_per_dispatch()
        if group > 1:
            batches = self._regroup_for_dispatch(batches, group, rng)
        for qt, idx, weights, true, L in batches:
            index = self.indexes[qt]
            queries = self.queries[qt][idx]
            rows, values, counts = index.get_all_coords(
                queries, return_counts=True
            )
            if L is None:
                L = pow2_bucket(int(counts.max()) if len(counts) else 1)
            pad_value = self._num_candidates(qt)  # out of range: dropped
            coords = np.full((self.batch_size, L), pad_value, dtype=np.int32)
            # each query's answers in its row (rows are sorted, so the
            # position within a row is a cumsum away)
            col = (
                np.arange(len(values), dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts)
            ) if len(values) else np.zeros(0, dtype=np.int64)
            coords[rows, col] = values
            # padding rows repeat query 0: weight 0, and no coordinates
            coords[weights == 0.0] = pad_value
            yield {
                "queries": queries.astype(np.int32),
                "label_coords": coords,
                "weights": weights,
                "size": np.float32(true),
                QTYPE_KEYS[qt]: np.zeros(0, dtype=np.int32),
            }

    def _regroup_for_dispatch(self, batches, group, rng):
        """``kge_tpu``'s batch order under grouped dispatch: the batches
        in runs of up to ``group`` of one query type and one label width,
        the runs shuffled against each other by the epoch's generator.
        The width rides along in the batch tuple."""
        keyed: Dict[tuple, List] = {}
        for qt, idx, weights, true, _ in batches:
            counts = self.indexes[qt].counts_for(self.queries[qt][idx])
            L = pow2_bucket(int(counts.max()) if len(counts) else 1)
            keyed.setdefault((qt, L), []).append((qt, idx, weights, true, L))
        runs = []
        for members in keyed.values():
            for i in range(0, len(members), group):
                runs.append(members[i:i + group])
        rng.shuffle(runs)
        return [b for run in runs for b in run]

    def _subbatch_loss(self, ctx: Ctx, batch, sl):
        queries = batch["queries"][sl]
        weights = batch["weights"][sl]
        coords = batch["label_coords"][sl]
        size = batch["size"]
        if "qtype_sp" in batch:
            scores = self.model.score_sp(queries[:, 0], queries[:, 1],
                                         ctx=ctx)
            smooth = True
        elif "qtype_po" in batch:
            scores = self.model.score_po(queries[:, 0], queries[:, 1],
                                         ctx=ctx)
            smooth = True
        else:
            scores = self.model.score_so(queries[:, 0], queries[:, 1],
                                         ctx=ctx)
            smooth = False
        rows, num = scores.shape
        # add, not set: a triple duplicated in the train split weights its
        # label by its multiplicity (kge_tpu's scatter-add); the padding
        # coordinate num lands in the extra column, which goes
        labels = torch.zeros((rows, num + 1), dtype=scores.dtype,
                             device=scores.device)
        labels.scatter_add_(1, coords, torch.ones_like(
            coords, dtype=scores.dtype))
        labels = labels[:, :num]
        if self.label_smoothing > 0 and smooth:
            # ConvE-style smoothing; the reference's additive term is
            # 1/num_entities, not eps/num_entities (train_KvsAll.py:263-266)
            labels = (
                (1.0 - self.label_smoothing) * labels
                + 1.0 / self.dataset.num_entities()
            )
        return self.loss(scores, labels, row_weights=weights) / size

    def _penalty_batch(self, batch):
        # queries are not triples: the penalty takes its unweighted form
        return {}
