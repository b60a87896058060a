"""1vsAll training (counterpart of ``kge_tpu/train/train_1vsall.py``;
reference: kge/job/train_1vsAll.py): each triple yields the (s, p, ?) and
(?, p, o) problems over all entities, two [B, E] score products and the
loss with index labels."""

from __future__ import annotations

import numpy as np

from kge_tpu_torch.models import Ctx
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import TrainingJob


class TrainingJob1vsAll(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        config.log("Initializing 1vsAll training job...")
        self.type_str = "1vsAll"
        if self.__class__ == TrainingJob1vsAll:
            for f in Job.job_created_hooks:
                f(self)

    def _prepare(self):
        self.triples = self.dataset.split(self.train_split)
        self.num_examples = len(self.triples)

    def _generate_batches(self, epoch: int):
        order = self._epoch_np_rng(epoch).permutation(self.num_examples)
        for idx, weights, true in self._pad_batch_indexes(order):
            yield {
                "triples": self.triples[idx].astype(np.int32),
                "weights": weights,
                "size": np.float32(true),
            }

    def _subbatch_loss(self, ctx: Ctx, batch, sl):
        triples = batch["triples"][sl]
        weights = batch["weights"][sl]
        size = batch["size"]
        scores_sp = self.model.score_sp(triples[:, 0], triples[:, 1],
                                        ctx=ctx)
        loss_sp = self.loss(scores_sp, triples[:, 2], row_weights=weights)
        scores_po = self.model.score_po(triples[:, 1], triples[:, 2],
                                        ctx=ctx)
        loss_po = self.loss(scores_po, triples[:, 0], row_weights=weights)
        return (loss_sp + loss_po) / size
