"""Hyperparameter search jobs (counterpart of ``kge_tpu/search/search.py``;
reference: kge/job/search*.py).

Trials run inline (``search.num_workers`` 1) or in a spawn-context process
pool, each trial on the next device of ``search.device_pool`` in turn
(``cuda:0``, ``cuda:1``, ...; empty means ``job.device``). Coordination is
by futures and trace files, as in the reference: a trial's payload is
plain data, ``run_trial`` runs it the same way inline and in a worker, and
with ``search.num_shards`` > 1 each shard runs its own trials and reads
the others' results from their trace files.
"""

from __future__ import annotations

import concurrent.futures
import copy
import gc
import os
from typing import Any, Dict, List

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.misc import init_from


class SearchJob(Job):
    """Base: manages a pool of training-job tasks."""

    def __init__(self, config: Config, dataset: Dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.num_workers = self.config.get("search.num_workers")
        self.device_pool: List[str] = list(self.config.get("search.device_pool"))
        if len(self.device_pool) == 0:
            self.device_pool = [self.config.get("job.device")]
        if len(self.device_pool) < self.num_workers:
            self.device_pool = (
                self.device_pool * self.num_workers
            )[: self.num_workers]
        self.on_error = self.config.check(
            "search.on_error", ["abort", "continue"]
        )
        self.num_shards = int(self.config.get("search.num_shards"))
        self.shard_index = int(self.config.get("search.shard_index"))
        if self.num_shards > 1 and not (
            0 <= self.shard_index < self.num_shards
        ):
            raise ValueError(
                f"search.shard_index {self.shard_index} out of range for "
                f"{self.num_shards} shards"
            )
        self.running_tasks = set()
        self.ready_task_results: List[Any] = []
        # pool is created lazily on first submit (GridSearchJob never
        # submits itself — it delegates to a ManualSearchJob with its
        # own pool) and shut down when run() returns
        self.process_pool = None

    def _ensure_pool(self):
        if self.process_pool is None and self.num_workers > 1:
            import multiprocessing as mp

            self.process_pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
            )
        return self.process_pool

    def run(self) -> Dict[str, Any]:
        try:
            return super().run()
        finally:
            if self.process_pool is not None:
                self.process_pool.shutdown(wait=True)
                self.process_pool = None

    @staticmethod
    def create(config: Config, dataset: Dataset, parent_job=None) -> "SearchJob":
        search_type = config.get("search.type")
        class_name = config.get_default(search_type + ".class_name")
        return init_from(
            class_name, config.modules(), config, dataset, parent_job=parent_job
        )

    def submit_task(self, task, task_arg, wait_when_full: bool = True):
        """Run task now (inline) or submit to the pool, assigning a device."""
        pool = self._ensure_pool()
        if pool is None:
            self.ready_task_results.append(task(task_arg))
        else:
            if len(self.running_tasks) >= self.num_workers and wait_when_full:
                self.wait_task()
            future = pool.submit(task, task_arg)
            self.running_tasks.add(future)

    def wait_task(self, return_when=concurrent.futures.FIRST_COMPLETED):
        """Wait for one or more running tasks to complete."""
        if len(self.running_tasks) > 0:
            done, self.running_tasks = concurrent.futures.wait(
                self.running_tasks, return_when=return_when
            )
            self.ready_task_results.extend(f.result() for f in done)

    # ------------------------------------------------------------ train trial

    def make_trial_payload(self, train_job_index: int, trial_config: Config,
                           train_job_count: int, trace_keys: List[str]):
        """Picklable payload for one trial: plain data only, so the same
        function runs inline or in a spawn-context worker process (bound
        methods / the SearchJob itself cannot cross the process boundary
        — the pool's futures hold thread locks)."""
        device = self.device_pool[train_job_index % len(self.device_pool)]
        return dict(
            index=train_job_index,
            options=copy.deepcopy(trial_config.options),
            folder=trial_config.folder,
            count=train_job_count,
            trace_keys=list(trace_keys),
            metric_name=self.config.get("valid.metric"),
            metric_max=bool(self.config.get("valid.metric_max")),
            on_error=self.on_error,
            device=device,
            dataset_folder=self.dataset.folder,
        )

    def owns_trial(self, index: int) -> bool:
        return self.num_shards <= 1 or \
            index % self.num_shards == self.shard_index

    def import_delegated_result(self, index: int, trial_folder: str
                                ) -> Dict[str, Any]:
        """Result of a trial owned by another shard, read from its trace
        file when visible on a shared filesystem (the reference's
        trace-file coordination model); a not-yet-finished or invisible
        trial reports as delegated with no metric."""
        metric_name = self.config.get("valid.metric")
        metric_max = bool(self.config.get("valid.metric_max"))
        tracefile = os.path.join(trial_folder, "trace.yaml")
        best, value = None, None
        if os.path.isfile(tracefile):
            from kge_tpu_torch.utils.trace import Trace

            trace = Trace(tracefile)
            entries = [
                e for e in trace.filter({"job": "eval"})
                if metric_name in e
            ] or [e for e in trace.entries if metric_name in e]
            if entries:
                values = [e[metric_name] for e in entries]
                pick = (max if metric_max else min)(
                    range(len(values)), key=values.__getitem__
                )
                best, value = dict(entries[pick]), values[pick]
        return dict(index=index, best=best, metric_value=value,
                    valid_entries=[], delegated=True)

    def record_trial_trace(self, result: Dict[str, Any]):
        """Copy a finished trial's validation entries into the search
        trace (reference: kge/job/search.py copy_to_search_trace)."""
        for entry in result.get("valid_entries") or []:
            self.config.trace(**entry)


def run_trial(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Run/resume one training trial from a plain-data payload (module
    level: runs identically inline and in a spawned worker process).
    Returns a picklable result dict (reference: kge/job/search.py:107-232).
    """
    index = payload["index"]
    try:
        config = Config()
        config.options = copy.deepcopy(payload["options"])
        config.folder = payload["folder"]
        config.set("job.device", payload["device"])
        # init_folder both creates the folder AND persists config.yaml
        # (a pre-existing makedirs would suppress the save, leaving the
        # trial folder without the config that `kge resume/test <trial>`
        # needs); an existing folder = trial resume, config already there
        config.init_folder()
        config.log(
            f"Starting training job {index + 1} of {payload['count']}..."
        )
        dataset = Dataset.create(config, folder=payload["dataset_folder"])

        checkpoint_file = None
        epoch = config.last_checkpoint_number()
        if epoch is not None:
            checkpoint_file = config.checkpoint_file(epoch)
        if checkpoint_file is not None:
            from kge_tpu_torch.utils.io import load_checkpoint

            checkpoint = load_checkpoint(checkpoint_file)
            job = Job.create_from(
                checkpoint, new_config=config, dataset=dataset
            )
        else:
            job = Job.create(config, dataset)
        job.run()

        hyperparameters = {
            key: config.get_default(key) for key in payload["trace_keys"]
        }
        valid_entries = []
        for entry in job.valid_trace:
            e = dict(entry)
            e.update(
                folder=os.path.basename(config.folder),
                train_job_index=index,
                scope="train",
                **hyperparameters,
            )
            valid_entries.append(e)

        # find best epoch; a trial whose validation never produced the
        # selection metric counts as failed
        metric_name = payload["metric_name"]
        valid_with_metric = [
            t for t in job.valid_trace if metric_name in t
        ]
        if valid_with_metric:
            values = [t[metric_name] for t in valid_with_metric]
            best_index = (
                max(range(len(values)), key=values.__getitem__)
                if payload["metric_max"]
                else min(range(len(values)), key=values.__getitem__)
            )
            best = dict(valid_with_metric[best_index])
            metric_value = best[metric_name]
        else:
            config.log(
                f"Trial {index} produced no '{metric_name}' validation "
                "entry; treating as failed"
            )
            best, metric_value = None, None
        del job
        gc.collect()
        return dict(index=index, best=best, metric_value=metric_value,
                    valid_entries=valid_entries)
    except (KeyboardInterrupt, SystemExit):
        # never swallow an interactive abort as a "failed trial" — with
        # on_error=continue the search would otherwise march straight on
        # to the next trial
        raise
    except BaseException as e:
        if payload["on_error"] == "continue":
            return dict(index=index, best=None, metric_value=None,
                        valid_entries=[], error=repr(e))
        raise
