"""Training-loss evaluation (counterpart of
``kge_tpu/evaluation/training_loss.py``; reference:
kge/job/eval_training_loss.py): a forward-only epoch of the configured
training strategy over the evaluation split, whose ``avg_loss`` is the
evaluation's metric. Under shared negative sampling with the fused loss
every step launches K1 (``ops/negsamp_loss.py``) without its backward;
the forward-only trainer resolves ``tpu.on_device_sampling`` as a training
job does, so it draws its negatives on the device where one would, and
its groups of steps dispatch as a training job's do."""

from __future__ import annotations

from kge_tpu_torch.evaluation.eval import EvaluationJob
from kge_tpu_torch.train.job import Job


class TrainingLossEvaluationJob(EvaluationJob):
    def __init__(self, config, dataset, parent_job=None, model=None):
        super().__init__(config, dataset, parent_job, model=model)
        from kge_tpu_torch.train.train import TrainingJob

        train_conf = config.clone()
        train_conf.set("job.type", "train")
        train_conf.set("train.split", self.eval_split)
        train_conf.log_folder = config.log_folder
        self._train_job = TrainingJob.create(
            train_conf, dataset, parent_job=self, model=self.model,
            forward_only=True,
        )
        if self.__class__ == TrainingLossEvaluationJob:
            for f in Job.job_created_hooks:
                f(self)

    def _evaluate(self):
        self._train_job.epoch = max(self.epoch, 0)
        if not self._train_job._is_prepared:
            self._train_job._prepare()
            self._train_job._is_prepared = True
        trace = self._train_job.run_epoch()
        self.current_trace["epoch"] = dict(
            type="training_loss",
            scope="epoch",
            split=self.eval_split,
            epoch=self.epoch,
            size=trace.get("size"),
            avg_loss=trace.get("avg_loss"),
            avg_cost=trace.get("avg_cost"),
            event="eval_completed",
        )
