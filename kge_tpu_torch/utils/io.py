"""Checkpoint I/O.

Checkpoints are single files ``checkpoint_{epoch:05d}.pt`` /
``checkpoint_best.pt`` (same naming contract as the reference,
kge/config.py:494-530) holding a pickled dict of numpy arrays plus
metadata, in the layout ``kge_tpu`` writes.

A ``kge_tpu`` checkpoint pickles classes of the JAX package and its
dependencies: ``checkpoint["config"]`` is a ``kge_tpu.config.Config``
and ``opt_state`` holds optax named tuples. A plain ``pickle.load``
would import ``kge_tpu``, optax and jax. ``load_checkpoint`` therefore
unpickles through :class:`CheckpointUnpickler`, which maps the config
onto the port's :class:`~kge_tpu_torch.config.Config`, maps optax named
tuples onto :class:`ForeignNamedTuple` (evaluation never reads
``opt_state``), and refuses every other global outside numpy and the
port itself.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

from kge_tpu_torch.config import Config


def get_checkpoint_file(config: Config, checkpoint_argument: str = "default"
                        ) -> Optional[str]:
    """Resolve which checkpoint to use: 'best' for eval jobs if present,
    else the last numbered one (reference: kge/util/io.py:7-33). With
    'default' and no checkpoint on disk, returns None for train jobs;
    eval jobs raise: evaluating a random init is never what was asked."""
    if checkpoint_argument == "default":
        if config.get("job.type") in ["eval", "valid", "test"]:
            checkpoint_file = config.checkpoint_file("best")
            if os.path.isfile(checkpoint_file):
                return checkpoint_file
        epoch = config.last_checkpoint_number()
        if epoch is not None:
            return config.checkpoint_file(epoch)
        if config.get("job.type") in ["eval", "valid", "test"]:
            raise FileNotFoundError(f"no checkpoint found in {config.folder}")
        return None
    if checkpoint_argument == "last":
        epoch = config.last_checkpoint_number()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {config.folder}")
        return config.checkpoint_file(epoch)
    return config.checkpoint_file(checkpoint_argument)


class ForeignNamedTuple(tuple):
    """Stand-in for a named tuple of a package the port does not load
    (optax optimizer state): keeps the fields, drops the type."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if (module, name) == ("kge_tpu.config", "Config"):
            return Config  # plain instance: pickle restores its __dict__
        if root == "optax":
            return ForeignNamedTuple
        if root in ("numpy", "kge_tpu_torch"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which the port does not "
            "load"
        )


def load_checkpoint(checkpoint_file: str) -> Dict[str, Any]:
    with open(checkpoint_file, "rb") as f:
        checkpoint = CheckpointUnpickler(f).load()
    checkpoint["file"] = checkpoint_file
    checkpoint["folder"] = os.path.dirname(checkpoint_file)
    return checkpoint


def save_checkpoint(checkpoint_file: str, checkpoint: Dict[str, Any]):
    tmp = checkpoint_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(checkpoint, f)
    os.replace(tmp, checkpoint_file)
