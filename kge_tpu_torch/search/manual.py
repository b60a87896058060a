"""Manual and grid search (counterpart of ``kge_tpu/search/manual.py``;
reference: kge/job/search_manual.py, search_grid.py)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List

from kge_tpu_torch.config import Config
from kge_tpu_torch.search.search import SearchJob
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.metric import Metric


class ManualSearchJob(SearchJob):
    """Run a fixed list of configurations, each in its own subfolder."""

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        if self.__class__ == ManualSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    def _run(self) -> Dict[str, Any]:
        configurations: List[Dict] = self.config.get(
            "manual_search.configurations"
        )
        run = self.config.get("manual_search.run")
        metric_name = self.config.get("valid.metric")

        tasks = []
        for i, conf in enumerate(configurations):
            conf = dict(conf)
            folder = conf.pop("folder", str(i).zfill(5))
            trial_config = self.config.clone(folder)
            trial_config.set("job.type", "train")
            trial_config.options.pop("search", None)
            flat: Dict[str, Any] = {}
            Config._flatten(conf, flat, prefix="")
            for key, value in flat.items():
                trial_config.set(key, value, create=True)
            tasks.append((i, trial_config, flat))

        if not run:
            for i, trial_config, _ in tasks:
                # creates the folder and persists the trial config.yaml
                # (required for manually running trials when run=False)
                trial_config.init_folder()
            self.config.log("manual_search.run is False; only created folders")
            return {}

        from kge_tpu_torch.search.search import run_trial

        for i, trial_config, flat in tasks:
            if not self.owns_trial(i):
                self.config.log(
                    f"Trial {i} delegated to shard "
                    f"{i % self.num_shards} of {self.num_shards}"
                )
                self.ready_task_results.append(
                    self.import_delegated_result(i, trial_config.folder)
                )
                continue
            self.submit_task(
                run_trial,
                self.make_trial_payload(i, trial_config, len(tasks),
                                        list(flat.keys())),
            )
        self.wait_task(return_when="ALL_COMPLETED")
        # delegated trials may have finished on their shard since their
        # one-time snapshot import; refresh from their trace files so the
        # final summary sees them (shared-filesystem coordination)
        folders = {i: tc.folder for i, tc, _ in tasks}
        self.ready_task_results = [
            self.import_delegated_result(r["index"], folders[r["index"]])
            if r.get("delegated") else r
            for r in self.ready_task_results
        ]

        best = None
        metric = Metric(self)
        for result in self.ready_task_results:
            self.record_trial_trace(result)
            if result.get("error"):
                self.config.log(
                    f"Trial {result['index']} failed: {result['error']}"
                )
            entry, value = result["best"], result["metric_value"]
            if entry is None or value is None:
                continue
            if best is None or metric.better(value, best[1]):
                best = (result["index"], value, entry)
        if best is not None:
            self.config.log(
                f"Best trial: {best[0]} with {metric_name}={best[1]}"
            )
            self.trace(
                event="search_completed", echo=True, log=True, scope="search",
                best_trial=best[0], metric_value=best[1],
            )
            return {"best_trial": best[0], "best_entry": best[2]}
        return {}


class GridSearchJob(SearchJob):
    """Expand a parameter grid into a ManualSearchJob
    (reference: kge/job/search_grid.py:23-71)."""

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        if self.__class__ == GridSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    def _run(self) -> Dict[str, Any]:
        grid = {
            k: v for k, v in Config.flatten(
                self.config.get("grid_search.parameters")
            ).items()
        }
        keys = list(grid.keys())
        values = [grid[k] if isinstance(grid[k], list) else [grid[k]]
                  for k in keys]
        # short folder names from abbreviated keys
        def abbrev(key):
            return "-".join(part[:3] for part in key.split("."))

        configurations = []
        for combo in itertools.product(*values):
            conf: Dict[str, Any] = {
                "folder": "_".join(
                    f"{abbrev(k)}={v}" for k, v in zip(keys, combo)
                )
            }
            for k, v in zip(keys, combo):
                conf[k] = v
            configurations.append(conf)
        self.config.log(
            f"Grid search: {len(configurations)} configurations"
        )
        search_config = self.config.clone()
        search_config.set("search.type", "manual_search")
        search_config.set("manual_search.configurations", configurations)
        search_config.set("manual_search.run",
                          self.config.get("grid_search.run"))
        job = ManualSearchJob(search_config, self.dataset, parent_job=self)
        return job.run()
