"""Trace file reader and console-format helpers (reference:
kge/job/trace.py).

trace.yaml holds one single-line YAML record per event. Filtering shells
out to grep when available (the reference's trick for large traces) and
falls back to pure Python.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Any, Dict, List, Optional

import yaml


class Trace:
    """An in-memory trace, filterable by key-value pairs."""

    def __init__(self, tracefile: Optional[str] = None,
                 regex_filter: Optional[str] = None):
        self.entries: List[Dict[str, Any]] = []
        if tracefile:
            self.load(tracefile, regex_filter)

    def load(self, tracefile: str, regex_filter: Optional[str] = None):
        pattern = re.compile(regex_filter) if regex_filter else None
        with open(tracefile, "r") as f:
            for line in f:
                if pattern and not pattern.search(line):
                    continue
                self.entries.append(yaml.safe_load(line))

    def filter(self, filter_dict: Optional[Dict[str, Any]] = None
               ) -> List[Dict[str, Any]]:
        if not filter_dict:
            return self.entries

        def predicate(entry):
            return all(entry.get(k) == v for k, v in filter_dict.items())

        return [e for e in self.entries if predicate(e)]

    @staticmethod
    def grep_training_trace_entries(tracefile: str, train: bool = True,
                                    valid: bool = False, test: bool = False,
                                    example: bool = False,
                                    batch: bool = False,
                                    job_id=None, epoch_of_last=None):
        """Training-chain extraction: follow the resumed-job chain of
        ``job_id`` backwards via ``resumed_from_job_id``, collecting train
        entries of every job in the chain plus eval entries attached to
        them (reference semantics: kge/job/trace.py:109-236).

        Returns (entries, job_epochs). ``job_epochs[jid]`` is the last
        epoch of ``jid`` that belongs to the stitched series: a resumed
        job may have re-trained epochs its predecessor also traced, and
        the predecessor's overlap must be dropped (epochs > the resume
        point). ``epoch_of_last`` caps the final job's epochs (e.g. the
        epoch of the checkpoint being dumped)."""
        if not job_id:
            raw = Trace.grep_entries(
                tracefile, ["scope: epoch", "job: train"], raw=True
            )
            if not raw:
                return [], {}
            job_id = yaml.safe_load(raw[-1]).get("job_id")
        if not job_id:
            raise ValueError(
                "no training entry found in trace; specify job_id"
            )

        scopes = {"epoch"}
        if example:
            scopes.add("example")
        if batch:
            scopes.add("batch")

        entries: List[Dict[str, Any]] = []
        job_epochs: Dict[str, Any] = {}
        current = job_id
        added_last = False
        # grep + parse the eval entries ONCE; a k-deep resume chain would
        # otherwise pay k full-file passes over every eval line
        all_evals: Optional[List[Dict[str, Any]]] = None
        while current:
            # eval entries attached to this chain job (child validations
            # via parent_job_id, standalone evals via resumed_from_job_id)
            if valid or test:
                if all_evals is None:
                    all_evals = [
                        e for e in Trace.grep_entries(
                            tracefile, [" job: eval"]
                        )
                        if e.get("scope") in scopes
                        and ((valid and e.get("split") in ("valid", "train"))
                             or (test and e.get("split") == "test"))
                    ]
                evals = [
                    e for e in all_evals
                    if e.get("parent_job_id") == current
                    or e.get("resumed_from_job_id") == current
                ]
                entries = evals + entries
            train_entries = [
                e for e in Trace.grep_entries(
                    tracefile, [f" job_id: {current}", " job: train"]
                )
                if e.get("scope") in scopes
            ]
            resumed_id = None
            if train_entries:
                if not added_last:
                    job_epochs[current] = (
                        epoch_of_last if epoch_of_last is not None
                        else float("inf")
                    )
                    added_last = True
                resumed_id = train_entries[0].get("resumed_from_job_id")
                if train:
                    entries = train_entries + entries
                if resumed_id:
                    # the predecessor's epochs beyond the resume point
                    # were re-trained by this job; drop the overlap
                    job_epochs[resumed_id] = (
                        train_entries[0].get("epoch", 1) - 1
                    )
            current = resumed_id
        return entries, job_epochs

    @staticmethod
    def grep_entries(tracefile: str, conjunctions: List[str],
                     raw: bool = False):
        """Entries whose line contains all the given substrings; uses
        grep when available (reference: kge/job/trace.py:62-107)."""
        if shutil.which("grep"):
            lines: Optional[List[str]] = None
            current = tracefile
            try:
                args = ["grep", "-F", conjunctions[0], tracefile]
                proc = subprocess.run(args, capture_output=True, text=True)
                if proc.returncode > 1:
                    # 0: matches, 1: no matches; >1: error (e.g. missing
                    # file) -- fall through to the pure-Python path so a
                    # typo'd path raises instead of returning []
                    raise OSError(proc.stderr.strip() or "grep failed")
                lines = proc.stdout.splitlines()
                for c in conjunctions[1:]:
                    out = subprocess.run(
                        ["grep", "-F", c], input="\n".join(lines),
                        capture_output=True, text=True,
                    ).stdout
                    lines = out.splitlines()
            except OSError:
                lines = None
            if lines is not None:
                if raw:
                    return lines
                return [yaml.safe_load(line) for line in lines if line]
        # fallback: pure python
        result = []
        with open(tracefile, "r") as f:
            for line in f:
                if all(c in line for c in conjunctions):
                    result.append(line if raw else yaml.safe_load(line))
        return result


def get_metric(entry: Dict[str, Any], metric_name: str) -> float:
    """Extract a metric from a trace entry, computing hits@K patterns on
    demand (reference: kge/job/trace.py:45-60)."""
    if metric_name in entry:
        return entry[metric_name]
    match = re.match(r"^hits(?:_at|@)_?(\d+)(.*)$", metric_name)
    if match:
        k, suffix = match.groups()
        alt = f"hits_at_{k}{suffix}"
        if alt in entry:
            return entry[alt]
    raise ValueError(f"metric {metric_name} not found in trace entry")


def format_trace_entry(format_key: str, trace_entry: Dict[str, Any],
                       config) -> Optional[str]:
    """Evaluate the user's console-format f-string expression for the
    given event key (reference: kge/job/trace.py:257-273 and
    config-default.yaml console.format)."""
    fmt = config.get("console.format") or {}
    expr = fmt.get(format_key)
    if not expr:
        return None
    import math

    scope = {"config": config, "trace": trace_entry, "math": math}
    scope.update(trace_entry)
    try:
        return str(eval(expr, None, scope))
    except Exception as e:
        return f"<error formatting {format_key}: {e}>"
