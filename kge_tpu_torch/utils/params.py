"""Parameter trees <-> torch state dicts.

A checkpoint stores a model's parameters as the nested dict of numpy
arrays that ``kge_tpu`` keeps (``checkpoint["model"]["params"]``, e.g.
``{"entity_embedder": {"weights": ...}, "relation_embedder": {...},
"scorer": {}}``). The port's modules name their parameters so that the
keys of ``state_dict()`` are that tree's paths joined with dots.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch


def state_dict_from_params(tree: Mapping[str, Any],
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of arrays into ``{"a.b": tensor}`` (CPU
    tensors sharing memory with writable numpy arrays)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = prefix + key
        if isinstance(value, Mapping):
            out.update(state_dict_from_params(value, path + "."))
        else:
            array = np.asarray(value)
            if not array.flags.writeable:  # torch tensors are writable
                array = array.copy()
            out[path] = torch.from_numpy(array)
    return out


def params_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Any]:
    """Nest ``{"a.b": tensor}`` back into ``{"a": {"b": ndarray}}``."""
    tree: Dict[str, Any] = {}
    for path, value in state_dict.items():
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested container in the order
    ``jax.tree_util.tree_leaves`` gives them: dict values by sorted key,
    tuples and lists in order (named tuples, including the stand-ins the
    checkpoint unpickler makes of optax's, are tuples), ``None`` and
    empty containers no leaf. Checkpoints' ``opt_state`` is read and
    written by this order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]
