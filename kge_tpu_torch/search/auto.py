"""AutoSearchJob: checkpointable trial loop where a backend proposes
parameter settings (counterpart of ``kge_tpu/search/auto.py``; reference:
kge/job/search_auto.py). The search checkpoint stores the config as a
plain options dict (``Config.save_to``), so a search folder resumes in
either package."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from kge_tpu_torch.search.search import SearchJob
from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint
from kge_tpu_torch.utils.metric import Metric


class AutoSearchJob(SearchJob):
    #: sentinel trial id: backend cannot generate yet, wait for results
    WAIT = "wait"

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.parameters: List[Dict[str, Any]] = []  # per trial
        self.results: List[Optional[Dict[str, Any]]] = []

    # backend API --------------------------------------------------------

    def init_search(self):
        raise NotImplementedError

    def register_trial(self, parameters: Optional[Dict] = None
                       ) -> Tuple[Optional[Dict], Optional[int]]:
        """Obtain the next trial's parameters from the backend.
        (None, AutoSearchJob.WAIT) means 'wait for earlier trials to
        finish first'; (None, None) terminates trial creation."""
        raise NotImplementedError

    def register_trial_result(self, trial_id, parameters, trace_entry):
        raise NotImplementedError

    def get_best_parameters(self):
        raise NotImplementedError

    # checkpointing ------------------------------------------------------

    def save(self, filename: str):
        save_checkpoint(
            filename,
            self.config.save_to({
                "type": "search",
                "parameters": self.parameters,
                "results": self.results,
                "job_id": self.job_id,
            }),
        )

    def _load(self, checkpoint: Dict):
        self.parameters = checkpoint["parameters"]
        self.results = checkpoint["results"]
        self.trace(event="job_resumed", checkpoint_file=checkpoint.get("file"))

    def resume(self):
        path = os.path.join(self.config.folder, "checkpoint_00000.pt")
        if os.path.isfile(path):
            self._load(load_checkpoint(path))

    # main loop ----------------------------------------------------------

    def _run(self) -> Dict[str, Any]:
        self.init_search()
        self.resume()
        metric_name = self.config.get("valid.metric")

        trial_no = 0
        while True:
            # obtain next trial
            if trial_no < len(self.parameters):
                parameters = self.parameters[trial_no]
                trial_id = trial_no
            else:
                parameters, trial_id = self.register_trial()
                if parameters is None and trial_id == self.WAIT:
                    self.wait_task()
                    self._collect_results(metric_name)
                    continue
                if trial_id is None:
                    break
                self.parameters.append(parameters)
                self.results.append(None)
            if trial_no < len(self.results) and self.results[trial_no] is not None:
                trial_no += 1
                continue  # already done (resumed)

            # create trial folder + config
            folder = str(trial_no).zfill(5)
            trial_config = self.config.clone(folder)
            trial_config.set("job.type", "train")
            trial_config.options.pop("search", None)
            for key, value in parameters.items():
                trial_config.set(key, value, create=True)

            from kge_tpu_torch.search.search import run_trial

            if not self.owns_trial(trial_no):
                self.config.log(
                    f"Trial {trial_no} delegated to shard "
                    f"{trial_no % self.num_shards} of {self.num_shards}"
                )
                self.ready_task_results.append(
                    self.import_delegated_result(
                        trial_no, trial_config.folder
                    )
                )
                self._collect_results(metric_name)
                trial_no += 1
                continue
            self.submit_task(
                run_trial,
                self.make_trial_payload(
                    trial_no, trial_config, self._planned_trials(),
                    list(parameters.keys()),
                ),
            )
            # collect any ready results
            self._collect_results(metric_name)
            self.save(os.path.join(self.config.folder, "checkpoint_00000.pt"))
            trial_no += 1

        self.wait_task(return_when="ALL_COMPLETED")
        self._collect_results(metric_name)
        # delegated trials may have finished on their shard since their
        # one-time snapshot import; refresh so the final summary and the
        # saved trial list see them (shared-filesystem coordination)
        for i in range(len(self.results)):
            if self.results[i] is None and not self.owns_trial(i):
                refreshed = self.import_delegated_result(
                    i, os.path.join(self.config.folder, str(i).zfill(5))
                )
                if refreshed["best"] is not None:
                    self.results[i] = refreshed["best"]
                    self.record_trial_trace(refreshed)
        self.save(os.path.join(self.config.folder, "checkpoint_00000.pt"))

        # summarize
        best_trial, best_entry = None, None
        metric = Metric(self)
        for i, result in enumerate(self.results):
            if result is None or metric_name not in result:
                continue
            if best_entry is None or metric.better(
                result[metric_name], best_entry[metric_name]
            ):
                best_trial, best_entry = i, result
        if best_entry is not None:
            self.config.log(
                f"Best trial: {best_trial} with {metric_name}="
                f"{best_entry[metric_name]}"
            )
            self.trace(
                event="search_completed", echo=True, log=True,
                scope="search",
                best_trial=best_trial,
                metric_value=best_entry[metric_name],
                **{f"best_{k}": v for k, v in self.parameters[best_trial].items()},
            )
        return {"best_trial": best_trial, "best_entry": best_entry}

    def _planned_trials(self) -> int:
        return -1

    def _collect_results(self, metric_name):
        for result in self.ready_task_results:
            trial_index = result["index"]
            best = result["best"]
            self.record_trial_trace(result)
            if result.get("error"):
                self.config.log(
                    f"Trial {trial_index} failed: {result['error']}"
                )
            while len(self.results) <= trial_index:
                self.results.append(None)
            self.results[trial_index] = best
            # failures are reported too (backends log them; ax would
            # otherwise leave the trial RUNNING forever)
            self.register_trial_result(
                trial_index, self.parameters[trial_index], best
            )
        self.ready_task_results = []
