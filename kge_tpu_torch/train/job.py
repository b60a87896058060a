"""Job base: factory, hooks, tracing (counterpart of
``kge_tpu/train/job.py``; reference: kge/job/job.py).

Jobs are host-side orchestration. The port runs evaluation jobs so far;
``job.type`` train and search raise "not yet ported".
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset


def _trace_job_creation(job: "Job"):
    """Log a trace entry when a job is created."""
    from kge_tpu_torch.utils.misc import get_git_revision_short_hash
    import os

    userhome = os.path.expanduser("~")
    username = os.path.split(userhome)[-1]
    job.trace_entry = job.config.trace(
        git_head=get_git_revision_short_hash(),
        username=username,
        hostname=os.uname().nodename,
        folder=job.config.folder,
        event="job_created",
    )


def _save_job_config(job: "Job"):
    """Save the job's config to a job-id-named file."""
    import os

    if job.config.folder:
        config_folder = os.path.join(job.config.folder, "config")
        if os.path.exists(config_folder):
            job.config.save(os.path.join(config_folder, f"{job.job_id}.yaml"))


class Job(Configurable):
    # hooks run when a job is created via the factory
    job_created_hooks: List[Callable[["Job"], Any]] = [
        _trace_job_creation,
        _save_job_config,
    ]

    def __init__(self, config: Config, dataset: Dataset,
                 parent_job: Optional["Job"] = None):
        super().__init__(config)
        self.dataset = dataset
        self.job_id = str(uuid.uuid4())
        self.parent_job = parent_job
        self.resumed_from_job_id: Optional[str] = None
        self.trace_entry: Dict[str, Any] = {}
        self._is_prepared = False
        # hook lists
        self.pre_run_hooks: List[Callable[[Job], Any]] = []
        self.post_run_hooks: List[Callable[[Job, Dict], Any]] = []

    @staticmethod
    def create(config: Config, dataset: Optional[Dataset] = None,
               parent_job: Optional["Job"] = None, model=None) -> "Job":
        """Create a job from ``job.type`` (only eval is ported)."""
        from kge_tpu_torch.evaluation.eval import EvaluationJob

        if dataset is None:
            dataset = Dataset.create(config)
        job_type = config.get("job.type")
        if job_type == "eval":
            return EvaluationJob.create(
                config, dataset, parent_job=parent_job, model=model
            )
        if job_type in ("train", "search"):
            raise NotImplementedError(
                f"job.type {job_type} is not yet ported to kge_tpu_torch"
            )
        raise ValueError(f"unknown job.type {job_type}")

    @staticmethod
    def create_from(checkpoint: Dict, new_config: Optional[Config] = None,
                    dataset: Optional[Dataset] = None,
                    parent_job: Optional["Job"] = None) -> "Job":
        """Reconstruct a job (and its model) from a checkpoint
        (reference: kge/job/job.py:94-132)."""
        config = Config.create_from(checkpoint)
        if new_config:
            config.load_config(new_config, create=True)
        dataset = Dataset.create_from(checkpoint, config, dataset)
        job = Job.create(config, dataset, parent_job)
        job._load(checkpoint)
        job.config.log("Loaded checkpoint from job " + str(checkpoint.get("job_id")))
        return job

    def _load(self, checkpoint: Dict):
        pass

    def _prepare(self):
        pass

    def run(self) -> Dict[str, Any]:
        if not self._is_prepared:
            self._prepare()
            self._is_prepared = True
        for f in self.pre_run_hooks:
            f(self)
        result = self._run()
        for f in self.post_run_hooks:
            f(self, result)
        return result

    def _run(self) -> Dict[str, Any]:
        raise NotImplementedError

    def trace(self, **kwargs) -> Dict[str, Any]:
        """Trace with this job's id and type chain attached."""
        job_type = self.config.get("job.type")
        return self.config.trace(
            job_id=self.job_id, job=job_type,
            **({"parent_job_id": self.parent_job.job_id}
               if self.parent_job else {}),
            # resume lineage: lets `kge dump trace` stitch the epoch
            # series of a resumed job chain back together (reference
            # kge/job/job.py trace fields + kge/job/trace.py:109-236)
            **({"resumed_from_job_id": self.resumed_from_job_id}
               if getattr(self, "resumed_from_job_id", None) else {}),
            **kwargs,
        )


class TrainingOrEvaluationJob(Job):
    """Adds batch/epoch hooks and the current-trace mechanism
    (reference: kge/job/job.py:182-199)."""

    def __init__(self, config: Config, dataset: Dataset,
                 parent_job: Optional[Job] = None):
        super().__init__(config, dataset, parent_job)
        self.current_trace: Dict[str, Optional[Dict]] = {
            "batch": None, "epoch": None
        }
        self.pre_batch_hooks: List[Callable[[Job], Any]] = []
        self.post_batch_hooks: List[Callable[[Job], Any]] = []
        self.pre_epoch_hooks: List[Callable[[Job], Any]] = []
        self.post_epoch_hooks: List[Callable[[Job], Any]] = []
