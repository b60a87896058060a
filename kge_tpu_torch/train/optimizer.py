"""Optimizer and learning-rate scheduling (counterpart of
``kge_tpu/train/optimizer.py``; reference: kge/util/optimizer.py).

Parameters fall into regex-defined groups: a named group declared under
``train.optimizer.<name>`` claims the parameters whose dotted name
matches its regex (overlaps are an error); the rest fall into
``default``. Each group has its own base learning rate and arguments.

Ported: dense Adagrad with torch semantics, ``sum += g^2; p -= lr * g /
(sqrt(sum) + eps)``, and dense plain SGD, ``p -= lr * g`` (``optax.identity``
in ``kge_tpu``), each after ``g += weight_decay * p`` when weight decay is
set (``optax.add_decayed_weights``). The state is one plain ``sum``
tensor per parameter for Adagrad and nothing for SGD; the training job
holds it and passes it in. Parameters named in ``sparse_paths`` (the
embedding tables of a row-sparse run) are left out of the dense step:
``sparse_row_update`` updates the rows a batch touched in every such
table, through one launch of the row-update kernel
(``ops/row_update.py``). SGD momentum and the other
optimizer types raise "not yet ported".

Checkpoints store the state in ``kge_tpu``'s leaf order (see
``opt_state_tree``): ``kge_tpu`` reads ``opt_state`` by position, after
flattening it the way ``jax.tree_util.tree_leaves`` does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from kge_tpu_torch.config import Config
from kge_tpu_torch.ops.row_update import row_update_groups
from kge_tpu_torch.utils.params import tree_leaves


def _path_key(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


def _group_args(config: Config) -> List[Dict[str, Any]]:
    """The ``args`` of every optimizer group, ``default`` first."""
    args = [dict(config.get("train.optimizer.default.args") or {})]
    for name in config.get("train.optimizer").keys():
        if name != "default":
            args.append(
                dict(config.get(f"train.optimizer.{name}.args") or {}))
    return args


def sparse_unsupported_reason(config: Config) -> Optional[str]:
    """Why row-sparse updates cannot replicate this optimizer exactly
    (None when they can). Torch draws the same line: sparse gradients
    work with Adagrad/plain SGD only (reference: lookup_embedder.yaml
    ``sparse`` + torch.optim sparse support)."""
    opt_type = config.get("train.optimizer.default.type").lower()
    if opt_type not in ("adagrad", "sgd"):
        return f"optimizer type {opt_type} has dense per-row state semantics"
    for args in _group_args(config):
        if args.get("weight_decay", 0.0):
            return "weight_decay touches every row each step"
        if opt_type == "sgd" and args.get("momentum", 0.0):
            return "SGD momentum decays untouched rows each step"
    return None


class KgeOptimizer:
    """Regex parameter groups, dense Adagrad or plain SGD over named
    parameters, and row-sparse updates of the ``sparse_paths`` tables."""

    def __init__(self, config: Config, params: Mapping[str, torch.Tensor],
                 sparse_paths: Sequence[str] = ()):
        self.config = config
        self.params = dict(params)
        self.sparse_paths: Tuple[str, ...] = tuple(sparse_paths)
        if self.sparse_paths:
            reason = sparse_unsupported_reason(config)
            if reason is not None:
                raise ValueError(f"sparse updates unsupported: {reason}")
        opt_type = config.get("train.optimizer.default.type")
        self.opt_type = opt_type.lower()
        if self.opt_type not in ("adagrad", "sgd"):
            raise NotImplementedError(
                f"train.optimizer type {opt_type} is not yet ported to "
                "kge_tpu_torch (Adagrad and SGD are)"
            )
        if self.opt_type == "sgd" and any(
                args.get("momentum", 0.0) or args.get("nesterov", False)
                for args in _group_args(config)):
            raise NotImplementedError(
                "SGD momentum and nesterov are not yet ported to "
                "kge_tpu_torch (plain SGD is)"
            )
        group_specs: List[Tuple[str, re.Pattern, Dict]] = []
        for name in config.get("train.optimizer").keys():
            if name == "default":
                continue
            regex = config.get(f"train.optimizer.{name}.regex")
            args = dict(config.get(f"train.optimizer.{name}.args") or {})
            group_specs.append((name, re.compile(regex), args))
        default_args = dict(config.get("train.optimizer.default.args") or {})

        self.group_names: List[str] = []
        self.base_lrs: Dict[str, float] = {}
        self._group_args: Dict[str, Dict[str, Any]] = {}
        for name, _, args in group_specs:
            merged = {**default_args, **args}
            self.group_names.append(name)
            self.base_lrs[name] = float(
                merged.get("lr", default_args.get("lr", 1.0))
            )
            self._group_args[name] = merged
        self.group_names.append("default")
        self.base_lrs["default"] = float(default_args.get("lr", 1.0))
        self._group_args["default"] = default_args

        #: parameter name -> group name
        self.group_of: Dict[str, str] = {}
        for path in self.params:
            matched = [n for n, rx, _ in group_specs if rx.search(path)]
            if len(matched) > 1:
                raise ValueError(
                    f"parameter {path} matched by multiple optimizer groups: "
                    f"{matched}"
                )
            self.group_of[path] = matched[0] if matched else "default"
        config.log(
            "optimizer groups: "
            + ", ".join(f"{g} (lr={self.base_lrs[g]})"
                        for g in self.group_names)
        )

    def _arg(self, name: str, key: str, default: float) -> float:
        return float(self._group_args[self.group_of[name]].get(key, default))

    def init(self) -> Dict[str, torch.Tensor]:
        """The Adagrad accumulators: parameter name -> ``sum`` tensor (the
        sparse tables' included); SGD keeps no state."""
        if self.opt_type == "sgd":
            return {}
        return {
            name: torch.full_like(
                p, self._arg(name, "initial_accumulator_value", 0.0)
            ).detach()
            for name, p in self.params.items()
        }

    @torch.no_grad()
    def step(self, state: Dict[str, torch.Tensor], lrs: Dict[str, float]):
        """One dense update, in place, of every parameter outside
        ``sparse_paths`` from its ``.grad`` (a parameter without one
        counts as a zero gradient)."""
        for name, p in self.params.items():
            if name in self.sparse_paths:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            weight_decay = self._arg(name, "weight_decay", 0.0)
            if weight_decay:
                g = g + weight_decay * p
            lr = lrs[self.group_of[name]]
            if self.opt_type == "sgd":
                p.sub_(lr * g)
                continue
            acc = state[name]
            acc.add_(g * g)
            eps = self._arg(name, "eps", 1e-10)
            p.sub_(lr * (g / (acc.sqrt() + eps)))

    @torch.no_grad()
    def sparse_row_update(
            self, state: Dict[str, torch.Tensor],
            rows: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
            lrs: Dict[str, float]):
        """The optimizer step on the touched rows of every sparse table of
        a step, in place: ``rows`` maps a table's name to ``(uniq,
        row_grads)``, its sorted row ids and their gradient rows (a run of
        equal ids carries its gradient at its last position). Each table
        keeps its group's ``lr`` and ``eps``. One launch of the row-update
        kernel for all tables on a card, its plain version on the host.
        Exact counterpart of torch sparse Adagrad / plain SGD on sparse
        gradients."""
        sgd = self.opt_type == "sgd"
        groups = [
            (self.params[name], None if sgd else state[name], uniq,
             row_grads, lrs[self.group_of[name]],
             self._arg(name, "eps", 1e-10))
            for name, (uniq, row_grads) in rows.items()]
        row_update_groups(self.opt_type, groups)

    # ------------------------------------------------------------------ state

    def opt_state_tree(self, state: Mapping[str, Any]) -> Dict[str, Any]:
        """``state`` in a tree of plain dicts whose leaves, flattened by
        ``tree_leaves`` (JAX's order), line up with those of ``kge_tpu``'s
        ``KgeOptimizer.init(params)``: ``{group: {"sum": {path...}}}``, and
        in a row-sparse run ``{"sparse": {path: {"sum": ...}}, "tx":
        {group: {"sum": {path...}}}}`` with the sparse tables under
        ``"sparse"`` only. Groups sort by name, parameters by path; optax's
        empty states, masked-out parameters and SGD give no leaves."""
        dense: Dict[str, Any] = {g: {"sum": {}} for g in self.group_names}
        sparse: Dict[str, Any] = {path: {} for path in self.sparse_paths}
        for name in sorted(self.params, key=_path_key):
            if name not in state:
                continue
            if name in self.sparse_paths:
                sparse[name]["sum"] = state[name]
                continue
            node = dense[self.group_of[name]]["sum"]
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = state[name]
        if self.sparse_paths:
            return {"sparse": sparse, "tx": dense}
        return dense

    def state_to_checkpoint(self, state: Dict[str, torch.Tensor]
                            ) -> Dict[str, Any]:
        return self.opt_state_tree(
            {k: v.detach().cpu().numpy() for k, v in state.items()}
        )

    def load_state(self, state: Dict[str, torch.Tensor], opt_state: Any):
        """Copy a checkpoint's ``opt_state`` (written by either package,
        by a dense or a row-sparse run) into ``state``, leaf by leaf in
        JAX's order."""
        names = tree_leaves(self.opt_state_tree({n: n for n in state}))
        leaves = tree_leaves(opt_state)
        if len(leaves) != len(names):
            raise ValueError(
                f"optimizer state in checkpoint has {len(leaves)} leaves, "
                f"expected {len(names)} (optimizer config changed?)"
            )
        with torch.no_grad():
            for name, leaf in zip(names, leaves):
                array = np.asarray(leaf)
                if tuple(array.shape) != tuple(state[name].shape):
                    raise ValueError(
                        f"optimizer state for {name} has shape "
                        f"{array.shape}, expected {tuple(state[name].shape)}"
                    )
                state[name].copy_(torch.from_numpy(
                    np.ascontiguousarray(array, dtype=np.float32)))


class KgeLRScheduler:
    """Host-side LR control: warmup + torch-style schedulers by name
    (reference: kge/util/optimizer.py:98-159 and train.py:199-233).

    ``lr_scale(epoch)`` multiplies every group's base lr; metric-based
    (ReduceLROnPlateau) scaling reacts to validation metrics.
    """

    def __init__(self, config: Config):
        self.config = config
        self.name = config.get("train.lr_scheduler")
        self.args = {
            k: v for k, v in (config.get("train.lr_scheduler_args") or {}).items()
            if k != "+++"
        }
        self.warmup_epochs = config.get("train.lr_warmup")
        self.metric_based = self.name == "ReduceLROnPlateau"
        self._scale = 1.0
        self._steps = 0
        # plateau state
        self._mode_max = config.get("valid.metric_max")
        self._best: Optional[float] = None
        self._bad_count = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "scale": self._scale, "steps": self._steps,
            "best": self._best, "bad_count": self._bad_count,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        self._scale = state.get("scale", 1.0)
        self._steps = state.get("steps", 0)
        self._best = state.get("best")
        self._bad_count = state.get("bad_count", 0)

    def step(self, metric: Optional[float] = None):
        """Advance one scheduler step (called once per epoch after valid)."""
        if not self.name:
            return
        self._steps += 1
        if self.metric_based:
            if metric is None:
                return
            factor = float(self.args.get("factor", 0.1))
            patience = int(self.args.get("patience", 10))
            threshold = float(self.args.get("threshold", 1e-4))
            better = False
            if self._best is None:
                better = True
            elif self._mode_max:
                better = metric > self._best * (1 + threshold)
            else:
                better = metric < self._best * (1 - threshold)
            if better:
                self._best = metric
                self._bad_count = 0
            else:
                self._bad_count += 1
                if self._bad_count > patience:
                    self._scale *= factor
                    self._bad_count = 0
                    self.config.log(
                        f"ReduceLROnPlateau: lr scale -> {self._scale}"
                    )
        elif self.name == "StepLR":
            step_size = int(self.args.get("step_size", 30))
            gamma = float(self.args.get("gamma", 0.1))
            self._scale = gamma ** (self._steps // step_size)
        elif self.name == "MultiStepLR":
            milestones = list(self.args.get("milestones", []))
            gamma = float(self.args.get("gamma", 0.1))
            self._scale = gamma ** sum(1 for m in milestones if self._steps >= m)
        elif self.name == "ExponentialLR":
            gamma = float(self.args.get("gamma", 0.95))
            self._scale = gamma ** self._steps
        elif self.name == "CosineAnnealingLR":
            t_max = int(self.args.get("T_max", 100))
            eta_min = float(self.args.get("eta_min", 0.0))
            self._scale = eta_min + (1 - eta_min) * 0.5 * (
                1 + np.cos(np.pi * min(self._steps, t_max) / t_max)
            )
        elif self.name == "ConstantLR":
            factor = float(self.args.get("factor", 1.0 / 3.0))
            total = int(self.args.get("total_iters", 5))
            self._scale = factor if self._steps < total else 1.0
        else:
            raise ValueError(f"unsupported lr scheduler {self.name}")

    def lr_scale(self, epoch: int) -> float:
        """Combined warmup x scheduler multiplier for the given epoch."""
        warmup = 1.0
        if self.warmup_epochs > 0 and epoch <= self.warmup_epochs:
            warmup = epoch / self.warmup_epochs
        return warmup * self._scale
