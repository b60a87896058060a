"""Command-line interface (counterpart of ``kge_tpu/cli.py``; reference:
kge/cli.py).

``python -m kge_tpu_torch start|create <config.yaml>`` starts (or only
creates) a training job in a new folder, ``resume <folder>`` continues a
job from its folder's last checkpoint, ``eval|valid|test <folder or
checkpoint>`` evaluates a checkpoint written by either package; every
flattened configuration key is available as a ``--key value`` flag.
``dump trace|checkpoint|config <source>`` prints a trace as CSV or YAML,
a checkpoint's metadata or a configuration (``utils/dump.py``);
``package <checkpoint>`` writes a distributable model file
(``utils/package.py``); ``import-libkge <checkpoint> --file <out>``
converts a LibKGE checkpoint (``utils/import_libkge.py``).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import traceback
from typing import Any, Dict, List, Optional

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.parallel import distributed as dist
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.utils.io import get_checkpoint_file, load_checkpoint
from kge_tpu_torch.utils.misc import kge_base_dir, resolve_device
from kge_tpu_torch.utils.seed import seed_from_config

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

    from kge_tpu_torch.utils.dump import add_dump_parsers

    add_dump_parsers(subparsers.add_parser(
        "dump", help="Dump trace, checkpoint, or config"))

    parser_package = subparsers.add_parser(
        "package", help="Strip a checkpoint into a distributable model file")
    parser_package.add_argument("checkpoint", type=str)
    parser_package.add_argument("--file", type=str, default=None)

    parser_import = subparsers.add_parser(
        "import-libkge",
        help="Convert a trained LibKGE (PyTorch) checkpoint into this "
             "framework's format")
    parser_import.add_argument("checkpoint", type=str)
    parser_import.add_argument("--file", type=str, required=True,
                               help="output checkpoint path")
    parser_import.add_argument("--dataset-folder", type=str, default=None,
                               help="dataset folder (required for R-GNN "
                                    "models; otherwise entity/relation "
                                    "counts are inferred from the tables)")
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
    # the ranks of a mesh run share one folder: rank 0 creates it
    dist.maybe_init_from_config(config)
    created = config.init_folder() if dist.is_primary() else True
    if not dist.broadcast_int(int(created)):
        raise ValueError(f"output folder {folder} already exists")
    dist.use_rank_log_folder(config)
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
    if args.command == "dump":
        from kge_tpu_torch.utils.dump import dump

        try:
            dump(args)
        except BrokenPipeError:
            # a pager or head closed the pipe: exit quietly
            sys.stderr.close()
        return None
    if args.command == "import-libkge":
        from kge_tpu_torch.utils.import_libkge import (
            import_reference_checkpoint)
        from kge_tpu_torch.utils.io import save_checkpoint

        checkpoint = import_reference_checkpoint(
            args.checkpoint, dataset_folder=args.dataset_folder)
        save_checkpoint(args.file, checkpoint)
        print(f"imported {args.checkpoint} -> {args.file}")
        return None
    if args.command == "package":
        from kge_tpu_torch.utils.package import package_model

        package_model(args.checkpoint, args.file)
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
