"""Command-line interface (counterpart of ``kge_tpu/cli.py``; reference:
kge/cli.py).

``python -m kge_tpu_torch start|create <config.yaml>`` starts (or only
creates) a training job in a new folder, ``resume <folder>`` continues a
job from its folder's last checkpoint, ``eval|valid|test <folder or
checkpoint>`` evaluates a checkpoint written by either package; every
flattened configuration key is available as a ``--key value`` flag.
``dump config <source>`` prints a configuration. The other verbs of
``kge_tpu`` exit with "not yet ported".
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import traceback
from typing import Any, Dict, List, Optional

import yaml

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import get_checkpoint_file, load_checkpoint
from kge_tpu_torch.utils.misc import kge_base_dir, resolve_device
from kge_tpu_torch.utils.seed import seed_from_config

NOT_PORTED = ("package", "import-libkge")

#: parser arguments that are not configuration keys
_NON_CONFIG = ("config", "folder", "run", "command", "checkpoint")


def argparse_bool_type(v):
    v = v.lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_config_flags(parser: argparse.ArgumentParser, config: Config):
    """One flag per flattened default key (reference: cli.py:61-69)."""
    for key, value in Config.flatten(config.options).items():
        if "+++" in key:
            continue
        arg_type = argparse_bool_type if isinstance(value, bool) else str
        parser.add_argument(f"--{key}", type=arg_type)
    parser.add_argument(
        "--abort-when-cache-outdated", action="store_const", const=True,
        default=None, dest="dataset.abort_when_cache_outdated",
    )


def create_parser(config: Config) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("kge_tpu_torch")
    subparsers = parser.add_subparsers(title="command", dest="command")
    subparsers.required = True
    parser_start = subparsers.add_parser(
        "start", help="Start a new job (create + run)")
    parser_create = subparsers.add_parser(
        "create", help="Create a new job folder without running")
    for p in (parser_start, parser_create):
        p.add_argument("config", type=str, nargs="?")
        p.add_argument("--folder", "-f", type=str)
        p.add_argument("--run", default=(p is parser_start),
                       type=argparse_bool_type)
        add_config_flags(p, config)
    for name, help_text in (
        ("resume", "Resume a prior job from its folder"),
        ("eval", "Evaluate a trained model"),
        ("valid", "Evaluate on the validation split"),
        ("test", "Evaluate on the test split"),
    ):
        p = subparsers.add_parser(name, help=help_text)
        p.add_argument("config", type=str)
        p.add_argument("--checkpoint", type=str, default="default",
                       help="which checkpoint to use: 'default', 'last', "
                            "'best', or an epoch number")
        add_config_flags(p, config)

    parser_dump = subparsers.add_parser("dump", help="Dump a configuration")
    dump_sub = parser_dump.add_subparsers(dest="dump_command")
    dump_sub.required = True
    p = dump_sub.add_parser("config", help="Dump a job's configuration")
    p.add_argument("source", type=str)
    p.add_argument("--raw", action="store_true")
    p.add_argument("--full", action="store_true")
    p.add_argument("--minimal", action="store_true")

    for name in NOT_PORTED:
        subparsers.add_parser(name, help="not yet ported")
    return parser


def _parse_unknown(unknown: List[str]) -> Dict[str, str]:
    """Interpret leftover ``--key value`` pairs as config options (keys
    from imported component yamls are not known before the model loads)."""
    overrides = {}
    i = 0
    while i < len(unknown):
        token = unknown[i]
        if not token.startswith("--"):
            raise ValueError(f"unexpected argument {token}")
        key = token[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(unknown):
                raise ValueError(f"missing value for --{key}")
            value = unknown[i + 1]
            i += 2
        overrides[key] = value
    return overrides


def _collect_overrides(args, config: Config) -> Dict[str, Any]:
    known = set(Config.flatten(config.options))
    return {
        key: value for key, value in vars(args).items()
        if value is not None and key not in _NON_CONFIG
        and (key in known or "." in key)
    }


def dump_config(args):
    """Print a configuration from a folder, config.yaml or checkpoint:
    raw, full (default), or only the keys that differ from the defaults."""
    source = args.source
    if os.path.isdir(source):
        source = os.path.join(source, "config.yaml")
    if source.endswith(".pt"):
        raw_options = Config.create_from(load_checkpoint(source)).options
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
    flat_default = Config.flatten(Config().options)
    diff = {
        k: v for k, v in Config.flatten(config.options).items()
        if flat_default.get(k, "<ABSENT>") != v
    }
    print(yaml.dump(diff, default_flow_style=False))


def _new_job_config(args, unknown: List[str]) -> Optional[Config]:
    """start/create: the job's config in a new folder (reference:
    cli.py:198-230); None for ``create`` without ``--run``."""
    config = Config()
    if args.config:
        config.load(args.config, create=True)
    for key, value in _collect_overrides(args, config).items():
        if key == "model":
            config._import(value)
        config.set(key, value, create=True)
    for key, value in _parse_unknown(unknown).items():
        config.set(key, value)  # unknown keys error (typo guard)
    if args.folder:
        folder = args.folder
    else:
        config_name = (
            os.path.splitext(os.path.basename(args.config))[0]
            if args.config else config.get("model") or "job"
        )
        timestamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        folder = os.path.join(kge_base_dir(), "local", "experiments",
                              f"{timestamp}-{config_name}")
    config.folder = folder
    if not config.init_folder():
        raise ValueError(f"output folder {folder} already exists")
    if args.command == "create" and not args.run:
        config.log(f"Created job folder {folder}")
        return None
    return config


def _folder_config(args, unknown: List[str], overrides: Dict[str, str]
                   ) -> Config:
    """resume/eval/valid/test: the folder's config with the command
    line's overrides (reference: cli.py:232-255)."""
    folder = args.config
    if os.path.isfile(folder):
        folder = os.path.dirname(folder) or "."
    config = Config(folder=folder)
    config.load(os.path.join(folder, "config.yaml"), create=True)
    for key, value in _collect_overrides(args, config).items():
        config.set(key, value, create=True)
    for key, value in overrides.items():
        config.set(key, value)
    for key, value in _parse_unknown(unknown).items():
        config.set(key, value)  # unknown keys error (typo guard)
    return config


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    """Run a command; return the job's result (the last epoch's trace
    entry of a training job, the evaluation's trace entry)."""
    config = Config()
    parser = create_parser(config)
    args, unknown = parser.parse_known_args(argv)
    if args.command in NOT_PORTED:
        sys.exit(f"kge_tpu_torch: '{args.command}' is not yet ported "
                 "(use python -m kge_tpu)")
    if args.command == "dump":
        dump_config(args)
        return None

    checkpoint = None
    if args.command in ("start", "create"):
        config = _new_job_config(args, unknown)
        if config is None:
            return None
    else:
        # eval/valid/test resume a job folder as an eval job (reference:
        # cli.py:158-165)
        overrides = {}
        if args.command != "resume":
            overrides["job.type"] = "eval"
            if args.command in ("valid", "test"):
                overrides["eval.split"] = args.command
        config = _folder_config(args, unknown, overrides)
        checkpoint_file = get_checkpoint_file(config, args.checkpoint)
        if checkpoint_file is not None:
            checkpoint = load_checkpoint(checkpoint_file)
        else:
            config.log(
                "No checkpoint found or specified, starting from scratch..."
            )

    try:
        seed_from_config(config, resolve_device(config))
        config.log("Using folder " + str(config.folder))
        dataset = Dataset.create(config)
        if checkpoint is not None:
            job = Job.create_from(checkpoint, new_config=config,
                                  dataset=dataset)
        else:
            job = Job.create(config, dataset)
        return job.run()
    except BaseException:
        config.log(traceback.format_exc(), echo=False)
        raise


if __name__ == "__main__":
    main()
