"""Optimizer and learning-rate scheduling (counterpart of
``kge_tpu/train/optimizer.py``; reference: kge/util/optimizer.py).

Parameters fall into regex-defined groups: a named group declared under
``train.optimizer.<name>`` claims the parameters whose dotted name
matches its regex (overlaps are an error); the rest fall into
``default``. Each group has its own base learning rate and arguments.

Ported: dense Adagrad with torch semantics, ``sum += g^2; p -= lr * g /
(sqrt(sum) + eps)``, after ``g += weight_decay * p`` when weight decay is
set (``optax.add_decayed_weights`` in ``kge_tpu``). The state is one
plain ``sum`` tensor per parameter, owned by the optimizer. Other
optimizer types and row-sparse updates raise "not yet ported".

Checkpoints store the state in ``kge_tpu``'s leaf order (see
``opt_state_tree``): ``kge_tpu`` reads ``opt_state`` by position, after
flattening it the way ``jax.tree_util.tree_leaves`` does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from kge_tpu_torch.config import Config
from kge_tpu_torch.utils.params import tree_leaves


def _path_key(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


class KgeOptimizer:
    """Regex parameter groups and dense Adagrad over named parameters."""

    def __init__(self, config: Config, params: Mapping[str, torch.Tensor]):
        self.config = config
        self.params = dict(params)
        opt_type = config.get("train.optimizer.default.type")
        if opt_type.lower() != "adagrad":
            raise NotImplementedError(
                f"train.optimizer type {opt_type} is not yet ported to "
                "kge_tpu_torch (Adagrad is)"
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
        """The Adagrad accumulators: parameter name -> ``sum`` tensor."""
        return {
            name: torch.full_like(
                p, self._arg(name, "initial_accumulator_value", 0.0)
            ).detach()
            for name, p in self.params.items()
        }

    @torch.no_grad()
    def step(self, state: Dict[str, torch.Tensor], lrs: Dict[str, float]):
        """One update, in place, from each parameter's ``.grad`` (a
        parameter without one counts as a zero gradient)."""
        for name, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            weight_decay = self._arg(name, "weight_decay", 0.0)
            if weight_decay:
                g = g + weight_decay * p
            acc = state[name]
            acc.add_(g * g)
            eps = self._arg(name, "eps", 1e-10)
            p.sub_(lrs[self.group_of[name]] * (g / (acc.sqrt() + eps)))

    # ------------------------------------------------------------------ state

    def opt_state_tree(self, state: Mapping[str, Any]) -> Dict[str, Any]:
        """``state`` in a tree of plain dicts whose leaves, flattened by
        ``tree_leaves`` (JAX's order), line up with those of ``kge_tpu``'s
        ``KgeOptimizer.init(params)``: ``{group: {"sum": {path...}}}``.
        Groups sort by name, parameters by path; optax's empty states and
        masked-out parameters give no leaves there."""
        tree: Dict[str, Any] = {g: {"sum": {}} for g in self.group_names}
        for name in sorted(self.params, key=_path_key):
            node = tree[self.group_of[name]]["sum"]
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = state[name]
        return tree

    def state_to_checkpoint(self, state: Dict[str, torch.Tensor]
                            ) -> Dict[str, Any]:
        return self.opt_state_tree(
            {k: v.detach().cpu().numpy() for k, v in state.items()}
        )

    def load_state(self, state: Dict[str, torch.Tensor], opt_state: Any):
        """Copy a checkpoint's ``opt_state`` (written by either package)
        into ``state``, leaf by leaf in JAX's order."""
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
