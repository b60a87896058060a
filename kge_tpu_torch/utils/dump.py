"""``dump {trace, checkpoint, config}`` (counterpart of
``kge_tpu/utils/dump.py``; reference: kge/util/dump.py).

- trace: filter trace.yaml records (train/eval/search scopes, epoch
  bounds, resumed-job chains) and emit CSV or YAML with the default
  column set plus user-requested keys
- checkpoint: print checkpoint metadata as YAML, weights elided
- config: print a job's configuration raw / full / minus-default
"""

from __future__ import annotations

import csv as csv_module
import os
import sys
from typing import Any, Dict, List, Optional

import yaml

from kge_tpu_torch.config import Config
from kge_tpu_torch.utils.io import load_checkpoint
from kge_tpu_torch.utils.params import tree_paths

DEFAULT_TRACE_KEYS = [
    "job_id", "dataset", "model", "reciprocal", "job", "split", "epoch",
    "avg_loss", "avg_penalty", "avg_cost", "metric_name", "metric",
]


def add_dump_parsers(parser):
    sub = parser.add_subparsers(dest="dump_command")
    sub.required = True

    p = sub.add_parser("trace", help="Dump trace to CSV/YAML")
    p.add_argument("source", type=str,
                   help="job folder, checkpoint file, or trace file")
    p.add_argument("--job-id", type=str, default=None,
                   help="dump the resumed-job chain ending at this job "
                        "(default: the job of the folder's last "
                        "checkpoint, else the last train entry)")
    p.add_argument("--train", action="store_true")
    p.add_argument("--valid", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--search", action="store_true")
    p.add_argument("--yaml", action="store_true")
    p.add_argument("--keysfile", type=str, default=None)
    p.add_argument("--keys", nargs="*", default=None)
    p.add_argument("--max-epoch", type=int, default=None)
    p.add_argument("--example", action="store_true")
    p.add_argument("--batch", action="store_true")
    p.add_argument("--checkpoint", action="store_true",
                   help="only entries up to the epoch of the job's last "
                        "checkpoint")
    p.add_argument("--truncate", action="store_true",
                   help="only entries up to the best validation epoch")
    p.add_argument("--no-header", action="store_true")
    p.add_argument("--no-default-keys", action="store_true")
    p.add_argument("--list-keys", action="store_true",
                   help="print all keys appearing in the selected entries "
                        "and exit")

    p = sub.add_parser("checkpoint", help="Dump checkpoint metadata")
    p.add_argument("source", type=str)
    p.add_argument("--keys", nargs="*", default=None)

    p = sub.add_parser("config", help="Dump a job's configuration")
    p.add_argument("source", type=str)
    p.add_argument("--raw", action="store_true")
    p.add_argument("--full", action="store_true")
    p.add_argument("--minimal", action="store_true")
    p.add_argument("--include", nargs="*", default=None,
                   help="restrict minimal output to these key prefixes")
    p.add_argument("--exclude", nargs="*", default=None,
                   help="drop these key prefixes from minimal output")


def dump(args):
    if args.dump_command == "trace":
        dump_trace(args)
    elif args.dump_command == "checkpoint":
        dump_checkpoint(args)
    elif args.dump_command == "config":
        dump_config(args)


def _resolve_trace_file(source: str) -> str:
    if os.path.isfile(source):
        return source
    path = os.path.join(source, "trace.yaml")
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(f"no trace found at {source}")


def read_trace(trace_file: str, filters: Optional[Dict[str, Any]] = None
               ) -> List[Dict[str, Any]]:
    entries = []
    with open(trace_file, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = yaml.safe_load(line)
            if filters and any(
                entry.get(k) != v for k, v in filters.items()
            ):
                continue
            entries.append(entry)
    return entries


def _last_numbered_checkpoint(folder: str) -> str:
    import glob as glob_module
    numbered = sorted(
        glob_module.glob(os.path.join(folder, "checkpoint_*.pt"))
    )
    numbered = [p for p in numbered if
                os.path.basename(p)[11:-3].isdigit()]
    return numbered[-1] if numbered else ""


def dump_trace(args):
    from kge_tpu_torch.utils.trace import Trace

    # resolve the source into (trace file, job folder, explicit checkpoint)
    checkpoint_path = None
    source = args.source
    if os.path.isfile(source) and source.endswith(".pt"):
        checkpoint_path = source
        folder = os.path.dirname(os.path.abspath(source))
        trace_file = os.path.join(folder, "trace.yaml")
        if not os.path.isfile(trace_file):
            raise FileNotFoundError(f"no trace found at {folder}")
    else:
        trace_file = _resolve_trace_file(source)
        folder = source if os.path.isdir(source) else \
            os.path.dirname(os.path.abspath(source))

    # determine the chain-terminating job id: explicit --job-id beats the
    # checkpoint's job_id beats the trace's last train entry (reference:
    # kge/util/dump.py:313-366)
    job_id = getattr(args, "job_id", None)
    max_epoch = args.max_epoch
    if getattr(args, "checkpoint", False) or getattr(args, "truncate", False):
        # cap at the epoch recorded in the folder's checkpoint (last for
        # --checkpoint, best for --truncate)
        path = checkpoint_path or (
            os.path.join(folder, "checkpoint_best.pt") if args.truncate
            else _last_numbered_checkpoint(folder)
        )
        if not path or not os.path.isfile(path):
            raise SystemExit(f"no suitable checkpoint found in {folder}")
        checkpoint = load_checkpoint(path)
        cap = int(checkpoint.get("epoch", 0))
        max_epoch = cap if max_epoch is None else min(max_epoch, cap)
        job_id = job_id or checkpoint.get("job_id")
    elif checkpoint_path:
        checkpoint = load_checkpoint(checkpoint_path)
        job_id = job_id or checkpoint.get("job_id")
    elif job_id is None and os.path.isdir(folder):
        # a job folder with checkpoints: dump the lineage of the last one
        path = _last_numbered_checkpoint(folder)
        if path:
            job_id = load_checkpoint(path).get("job_id")

    entry_type_specified = args.train or args.valid or args.test or args.search
    want_train = args.train or not entry_type_specified
    want_valid = args.valid or not entry_type_specified
    want_test = args.test or not entry_type_specified

    selected: List[Dict[str, Any]] = []
    if not args.search:
        # training-chain extraction: walk resumed_from_job_id backwards,
        # drop each predecessor's epochs that its successor re-trained
        chain, job_epochs = Trace.grep_training_trace_entries(
            trace_file, train=want_train, valid=want_valid, test=want_test,
            example=args.example, batch=args.batch, job_id=job_id,
            epoch_of_last=max_epoch,
        )
        for e in chain:
            # cap train entries by their own job's surviving epochs, and
            # eval entries by the chain job they are attached to — a
            # predecessor's validations of re-trained epochs must drop
            # with the train entries (reference kge/util/dump.py:442-448)
            if e.get("job") == "train":
                jid = e.get("job_id")
            else:
                # an eval entry may carry BOTH fields; cap by whichever
                # attached it to the chain (i.e. the one in job_epochs)
                jid = next(
                    (x for x in (e.get("resumed_from_job_id"),
                                 e.get("parent_job_id"))
                     if x in job_epochs),
                    None,
                )
            cap = job_epochs.get(jid, float("inf"))
            if (e.get("epoch") or 0) > cap:
                continue
            if max_epoch is not None and (e.get("epoch") or 0) > max_epoch:
                continue
            selected.append(e)
    if not selected and (args.search or not entry_type_specified):
        # search-job folder: per-trial summary entries (reference
        # fallback, kge/util/dump.py:370-376)
        scopes = {"epoch", "train", "search"}
        if args.example:
            scopes.add("example")
        if args.batch:
            scopes.add("batch")
        selected = [
            e for e in read_trace(trace_file)
            if e.get("job") in {"train", "eval", "search"}
            and e.get("scope") in scopes
            and (max_epoch is None or (e.get("epoch") or 0) <= max_epoch)
        ]
    if not selected:
        raise SystemExit("no relevant trace entries found")

    if getattr(args, "list_keys", False):
        all_keys = set()
        for e in selected:
            all_keys.update(e.keys())
        for k in sorted(all_keys):
            print(k)
        return

    keys = [] if getattr(args, "no_default_keys", False) \
        else list(DEFAULT_TRACE_KEYS)
    if args.keysfile:
        with open(args.keysfile) as f:
            keys += [ln.strip() for ln in f if ln.strip()]
    if args.keys:
        keys += args.keys

    if args.yaml:
        for e in selected:
            print(yaml.dump(e, default_flow_style=True, width=float("inf"))
                  .strip())
        return
    writer = csv_module.writer(sys.stdout)
    if not getattr(args, "no_header", False):
        writer.writerow(keys)
    for e in selected:
        row = []
        for k in keys:
            if k == "metric_name":
                row.append(e.get("metric_name", ""))
            elif k == "metric":
                # common metric shorthand
                row.append(
                    e.get("mean_reciprocal_rank_filtered_with_test",
                          e.get("mean_reciprocal_rank_filtered", ""))
                )
            else:
                row.append(e.get(k, ""))
        writer.writerow(row)


def dump_checkpoint(args):
    checkpoint = load_checkpoint(args.source)
    excluded = {"model", "opt_state", "rng"}
    out = {}
    for key, value in checkpoint.items():
        if args.keys and key not in args.keys:
            continue
        if key in excluded:
            continue
        if key == "config":
            out["config"] = value.options if isinstance(value, Config) else value
        else:
            out[key] = value
    if "model" in checkpoint and (not args.keys or "parameter_names" in args.keys):
        out["parameter_names"] = tree_paths(checkpoint["model"]["params"])
    print(yaml.dump(out, default_flow_style=False))


def dump_config(args):
    source = args.source
    if os.path.isdir(source):
        source = os.path.join(source, "config.yaml")
    if source.endswith(".pt"):
        checkpoint = load_checkpoint(source)
        config = Config.create_from(checkpoint)
        raw_options = config.options
    else:
        with open(source) as f:
            raw_options = yaml.safe_load(f)
    if args.raw:
        print(yaml.dump(raw_options, default_flow_style=False))
        return
    config = Config()
    config.load_options(dict(raw_options), create=True)
    if args.full or not args.minimal:
        print(yaml.dump(config.options, default_flow_style=False))
        return
    # minimal: only keys that differ from the defaults
    default = Config()
    flat_default = Config.flatten(default.options)
    flat = Config.flatten(config.options)
    diff = {
        k: v for k, v in flat.items()
        if flat_default.get(k, "<ABSENT>") != v
    }
    include = getattr(args, "include", None)
    exclude = getattr(args, "exclude", None)
    if include:
        diff = {k: v for k, v in diff.items()
                if any(k == p or k.startswith(p + ".") for p in include)}
    if exclude:
        diff = {k: v for k, v in diff.items()
                if not any(k == p or k.startswith(p + ".") for p in exclude)}
    print(yaml.dump(diff, default_flow_style=False))
