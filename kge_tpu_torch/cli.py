"""Command-line interface (counterpart of ``kge_tpu/cli.py``; reference:
kge/cli.py).

``python -m kge_tpu_torch eval|valid|test <folder or checkpoint>``
evaluates a checkpoint written by either package, with every flattened
configuration key available as a ``--key value`` flag;
``python -m kge_tpu_torch dump config <source>`` prints a configuration.
The other verbs of ``kge_tpu`` exit with "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Any, Dict, List, Optional

import yaml

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import get_checkpoint_file, load_checkpoint
from kge_tpu_torch.utils.misc import resolve_device
from kge_tpu_torch.utils.seed import seed_from_config

NOT_PORTED = ("start", "create", "resume", "package", "import-libkge")


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
    for name, help_text in (
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


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    """Run a command; for eval/valid/test, return the evaluation's trace
    entry (metrics included)."""
    config = Config()
    parser = create_parser(config)
    args, unknown = parser.parse_known_args(argv)
    if args.command in NOT_PORTED:
        sys.exit(f"kge_tpu_torch: '{args.command}' is not yet ported "
                 "(use python -m kge_tpu)")
    if args.command == "dump":
        dump_config(args)
        return None

    # eval/valid/test resume a job folder (reference: cli.py:158-165)
    overrides = {"job.type": "eval"}
    if args.command in ("valid", "test"):
        overrides["eval.split"] = args.command
    folder = args.config
    if os.path.isfile(folder):
        folder = os.path.dirname(folder) or "."
    config = Config(folder=folder)
    config.load(os.path.join(folder, "config.yaml"), create=True)
    known = set(Config.flatten(config.options))
    for key, value in vars(args).items():
        if value is not None and (key in known or "." in key):
            config.set(key, value, create=True)
    for key, value in overrides.items():
        config.set(key, value)
    for key, value in _parse_unknown(unknown).items():
        config.set(key, value)  # unknown keys error (typo guard)
    checkpoint = load_checkpoint(get_checkpoint_file(config, args.checkpoint))

    try:
        seed_from_config(config, resolve_device(config))
        config.log("Using folder " + str(config.folder))
        dataset = Dataset.create(config)
        job = Job.create_from(checkpoint, new_config=config, dataset=dataset)
        return job.run()
    except BaseException:
        config.log(traceback.format_exc(), echo=False)
        raise


if __name__ == "__main__":
    main()
