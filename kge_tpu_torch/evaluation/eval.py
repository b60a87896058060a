"""Evaluation job base (counterpart of ``kge_tpu/evaluation/eval.py``;
reference: kge/job/eval.py)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models import KgeModel
from kge_tpu_torch.train.job import TrainingOrEvaluationJob
from kge_tpu_torch.utils.misc import init_from, resolve_device
from kge_tpu_torch.utils.trace import format_trace_entry


class EvaluationJob(TrainingOrEvaluationJob):
    def __init__(self, config: Config, dataset: Dataset, parent_job=None,
                 model: Optional[KgeModel] = None):
        super().__init__(config, dataset, parent_job)
        self.device = resolve_device(config)
        if model is None:
            model = KgeModel.create(config, dataset, device=self.device,
                                    init_for_load_only=True)
        self.model = model
        self.batch_size = config.get("eval.batch_size")
        self.eval_split = config.get("eval.split")
        self.trace_examples = config.get("eval.trace_level") == "example"
        self.epoch = -1
        self.hist_hooks = []
        self.verbose = True

    @staticmethod
    def create(config: Config, dataset: Dataset, parent_job=None,
               model: Optional[KgeModel] = None) -> "EvaluationJob":
        eval_type = config.get("eval.type")
        class_name = config.get_default(eval_type + ".class_name")
        return init_from(
            class_name, config.modules(), config, dataset,
            parent_job=parent_job, model=model,
        )

    def _run(self) -> Dict[str, Any]:
        self._evaluate()
        epoch_trace = self.current_trace["epoch"]
        self.current_trace["epoch"] = None

        # compute custom metric expression if the configured metric is
        # missing (reference: kge/job/eval.py:69-76)
        metric_name = self.config.get("valid.metric")
        if metric_name not in epoch_trace:
            epoch_trace[metric_name] = eval(
                self.config.get("valid.metric_expr"),
                None,
                {"config": self.config, "math": math, **epoch_trace},
            )
        epoch_trace = self.trace(**epoch_trace, echo=self.verbose, log=True)
        line = format_trace_entry("eval_epoch", epoch_trace, self.config)
        if line:
            self.config.log(line)
        return epoch_trace

    def _evaluate(self):
        """Fill self.current_trace['epoch']."""
        raise NotImplementedError

    def _load(self, checkpoint: Dict):
        """Load the checkpoint's numpy tables into the model on the job's
        device."""
        if checkpoint["type"] not in ["train", "package"]:
            raise ValueError("can only evaluate train/package checkpoints")
        self.model.load_params(checkpoint["model"]["params"])
        self.epoch = checkpoint.get("epoch", -1)
        self.resumed_from_job_id = checkpoint.get("job_id")
        self.trace(event="job_resumed", checkpoint_file=checkpoint.get("file"))
