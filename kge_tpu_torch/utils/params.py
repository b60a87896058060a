"""Parameter trees <-> torch state dicts.

A checkpoint stores a model's parameters as the nested container of
numpy arrays that ``kge_tpu`` keeps (``checkpoint["model"]["params"]``,
e.g. ``{"entity_embedder": {"weights": ...}, "relation_embedder": {...},
"scorer": {}}``). Dicts and lists nest: the Transformer's scorer holds a
list of layers (``{"scorer": {"layers": [{...}, ...]}}``). The port's
modules name their parameters so that the keys of ``state_dict()`` are
that tree's paths joined with dots, a list entry by its index
(``scorer.layers.0.qkv_w``, the key ``nn.ModuleList`` gives).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping

import numpy as np
import torch


def state_dict_from_params(tree: Mapping[str, Any],
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested container of arrays into ``{"a.b": tensor}``, list
    entries keyed by their index (CPU tensors sharing memory with
    writable numpy arrays)."""
    out: Dict[str, torch.Tensor] = {}
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for key, value in items:
        path = prefix + str(key)
        if isinstance(value, (Mapping, list, tuple)):
            out.update(state_dict_from_params(value, path + "."))
        else:
            array = np.asarray(value)
            if not array.flags.writeable:  # torch tensors are writable
                array = array.copy()
            out[path] = torch.from_numpy(array)
    return out


def _listify(node: Any) -> Any:
    """Dicts whose keys are exactly ``"0" .. "n-1"`` -> lists, recursively
    (the nodes that were lists before flattening)."""
    if not isinstance(node, dict):
        return node
    node = {key: _listify(value) for key, value in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Nest ``{"a.b": leaf}`` into ``{"a": {"b": leaf}}``; a node keyed
    ``0 .. n-1`` becomes a list (it was one before flattening)."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _listify(tree)


def params_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Any]:
    """``{"a.b": tensor}`` -> the nested tree of numpy arrays."""
    return nest({path: value.detach().cpu().numpy()
                 for path, value in state_dict.items()})


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict/list."""
    if isinstance(tree, Mapping):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, value) for value in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested container in the order
    ``jax.tree_util.tree_leaves`` gives them: dict values by sorted key,
    tuples and lists in index order (named tuples, including the
    stand-ins the checkpoint unpickler makes of optax's, are tuples),
    ``None`` and empty containers no leaf. Checkpoints' ``opt_state`` is
    read and written by this order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_paths(tree: Any, prefix: str = "") -> List[str]:
    """The dotted path of each leaf, in ``tree_leaves``' order and as
    ``jax.tree_util.tree_flatten_with_path`` names them in ``kge_tpu``'s
    ``dump checkpoint`` (dict keys as they are, list positions as
    ``[i]``)."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [path for key in sorted(tree)
                for path in tree_paths(tree[key], f"{prefix}{key}.")]
    if isinstance(tree, (tuple, list)):
        return [path for i, item in enumerate(tree)
                for path in tree_paths(item, f"{prefix}[{i}].")]
    return [prefix[:-1]]
