"""Optimizer and learning-rate scheduling (counterpart of
``kge_tpu/train/optimizer.py``; reference: kge/util/optimizer.py).

Parameters fall into regex-defined groups: a named group declared under
``train.optimizer.<name>`` claims the parameters whose dotted name
matches its regex (overlaps are an error); the rest fall into
``default``. Each group has its own base learning rate and arguments.

Every optimizer type of ``kge_tpu`` is here, with the formulas of the
optax transforms it chains (``kge_tpu/train/optimizer.py:61-114``),
written out in torch and applied in place:

- Adagrad with torch semantics: ``sum += g^2; u = g / (sqrt(sum) + eps)``;
- Adam and AdamW (``scale_by_adam``): ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, ``u = mu_hat / (sqrt(nu_hat) + eps)``
  with the bias corrections ``1 - b**count`` computed in float32;
- Adamax (``scale_by_adamax``): ``nu = max(|g| + eps, b2 nu)``,
  ``u = mu_hat / nu``;
- RMSprop (``scale_by_rms``): ``nu = (1-alpha) g^2 + alpha nu``,
  ``u = g * rsqrt(nu + eps)`` (eps inside the root, no bias correction);
- Adadelta (``scale_by_adadelta``): ``u = sqrt(e_x + eps) / sqrt(e_g +
  eps) * g`` between the updates of ``e_g`` and ``e_x``;
- SGD: ``u = g``, or with ``momentum`` (``trace``) ``t = g + m t`` and
  ``u = t`` (``u = g + m t`` with ``nesterov``).

The dense step is written so that a CUDA graph can capture it: no
host sync and no value read on the host. Learning rates may be 0-d
device tensors (the training job fills them before each epoch), and the
Adam family's bias corrections arrive as a device tensor that the host
computed (``advance``), since the step count lives on the host.

``weight_decay`` adds ``wd * p`` to ``g`` before the preconditioner for
every type but AdamW, which adds ``(wd or 1e-2) * p`` to ``u`` after it;
then ``p -= lr * u``. The state is ``{slot: {parameter name: tensor}}``
(the slots of the type: ``sum``; ``mu``, ``nu``; ``nu``; ``e_g``,
``e_x``; ``trace``) plus, for the Adam family, ``{"count": {group: int32
scalar}}`` on the host; the training job holds it and passes it in.
Parameters named in ``sparse_paths`` (the embedding tables of a
row-sparse run, Adagrad and plain SGD only) are left out of the dense
step: ``sparse_row_update`` updates the rows a batch touched in every
such table, through one launch of the row-update kernel
(``ops/row_update.py``).

Checkpoints store the state in ``kge_tpu``'s leaf order (see
``opt_state_tree``): ``kge_tpu`` reads ``opt_state`` by position, after
flattening it the way ``jax.tree_util.tree_leaves`` does.

Under a device mesh the slots of a table stored as a row block
(``sharded``: the model's ``sharded_tables``) are that block too:
``state_to_checkpoint`` gathers them whole, ``load_state`` takes the
block of a whole one, and ``sparse_row_update`` is given the rows of
the step its block owns, as local ids (``TrainingJob._owned_rows``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from kge_tpu_torch.config import Config
from kge_tpu_torch.ops.row_update import row_update_groups
from kge_tpu_torch.parallel.distributed import fetch_global, put_global
from kge_tpu_torch.utils.misc import to_device
from kge_tpu_torch.utils.params import nest, tree_leaves

#: per-parameter state slots of each optimizer type, in optax's order
STATE_SLOTS = {"adagrad": ("sum",), "adam": ("mu", "nu"),
               "adamw": ("mu", "nu"), "adamax": ("mu", "nu"),
               "rmsprop": ("nu",), "adadelta": ("e_g", "e_x"), "sgd": ()}
#: types whose optax state holds a step count (an int32 scalar per group)
COUNTED = ("adam", "adamw", "adamax")
INT32_MAX = 2 ** 31 - 1


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: torch's
    float32 ``pow`` on the host rounds as XLA's does (numpy's differs in
    the last bit at some counts, which ``1 - x`` magnifies)."""
    power = torch.pow(torch.tensor(decay, dtype=torch.float32),
                      torch.tensor(float(count)))
    return float(1 - power)


def _betas(args: Mapping[str, Any]) -> Tuple[float, float]:
    """The Adam family's ``(b1, b2)`` from a group's ``args``."""
    b1, b2 = args.get("betas", (0.9, 0.999))
    return float(b1), float(b2)


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
    """Regex parameter groups, the dense step of every optimizer type over
    named parameters, and row-sparse updates of the ``sparse_paths``
    tables."""

    def __init__(self, config: Config, params: Mapping[str, torch.Tensor],
                 sparse_paths: Sequence[str] = (),
                 sharded: Optional[Mapping[str, Any]] = None):
        self.config = config
        self.params = dict(params)
        self.sparse_paths: Tuple[str, ...] = tuple(sparse_paths)
        #: the tables stored as a row block under a mesh, by name, with
        #: their embedders (``KgeModel.sharded_tables``)
        self.sharded: Dict[str, Any] = dict(sharded or {})
        if self.sparse_paths:
            reason = sparse_unsupported_reason(config)
            if reason is not None:
                raise ValueError(f"sparse updates unsupported: {reason}")
        opt_type = config.get("train.optimizer.default.type")
        self.opt_type = opt_type.lower()
        if self.opt_type not in STATE_SLOTS:
            raise ValueError(f"unsupported optimizer type {opt_type}")
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

    def _slots(self, group: str) -> Tuple[str, ...]:
        """The per-parameter state slots of ``group`` (SGD keeps a trace
        only in a group with momentum)."""
        if self.opt_type == "sgd":
            return ("trace",) if self._group_args[group].get(
                "momentum", 0.0) else ()
        return STATE_SLOTS[self.opt_type]

    def init(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The optimizer state: ``{slot: {parameter name: tensor}}`` (the
        sparse tables' Adagrad sums included) and, for the Adam family,
        ``{"count": {group: 0-d int32 tensor on the host}}``."""
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in self.params.items():
            for slot in self._slots(self.group_of[name]):
                fill = (self._arg(name, "initial_accumulator_value", 0.0)
                        if slot == "sum" else 0.0)
                state.setdefault(slot, {})[name] = torch.full_like(
                    p, fill).detach()
        if self.opt_type in COUNTED:
            state["count"] = {g: torch.zeros((), dtype=torch.int32)
                              for g in self.group_names}
        return state

    def advance(self, state: Dict[str, Dict[str, torch.Tensor]],
                steps: int) -> Optional[np.ndarray]:
        """Advance the Adam family's step counts by ``steps`` and return
        the bias corrections ``(1 - b1**count, 1 - b2**count)`` of those
        steps, float32 [steps, groups, 2] in ``group_names`` order (None
        for the other types). The host computes them, as optax does in
        float32, for a group of steps before it dispatches them."""
        if self.opt_type not in COUNTED:
            return None
        out = np.empty((steps, len(self.group_names), 2), dtype=np.float32)
        for j, group in enumerate(self.group_names):
            count = state["count"][group]
            value = int(count)
            betas = _betas(self._group_args[group])
            for i in range(steps):
                value = min(value + 1, INT32_MAX)
                out[i, j] = [_bias_correction(b, value) for b in betas]
            count.fill_(value)
        return out

    @torch.no_grad()
    def step(self, state: Dict[str, Dict[str, torch.Tensor]],
             lrs: Mapping[str, Any],
             corrections: Optional[torch.Tensor] = None):
        """One dense update, in place, of every parameter outside
        ``sparse_paths`` from its ``.grad`` (a parameter without one
        counts as a zero gradient). ``lrs`` maps each group to its
        learning rate, a float or a 0-d tensor on the parameters' device;
        ``corrections`` is this step's row of ``advance`` on that device
        (the Adam family; by default the step advances the counts
        itself)."""
        if self.opt_type in COUNTED and corrections is None:
            device = next(iter(self.params.values())).device
            corrections = to_device(self.advance(state, 1)[0], device)
        for name, p in self.params.items():
            if name in self.sparse_paths:
                continue
            group = self.group_of[name]
            args = self._group_args[group]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            weight_decay = float(args.get("weight_decay", 0.0))
            if weight_decay and self.opt_type != "adamw":
                g = g + weight_decay * p
            u = self._precondition(
                name, g, state, args, None if corrections is None
                else corrections[self.group_names.index(group)])
            if self.opt_type == "adamw":
                u = u + (weight_decay or 1e-2) * p
            p.sub_(lrs[group] * u)

    def _precondition(self, name: str, g: torch.Tensor,
                      state: Dict[str, Dict[str, torch.Tensor]],
                      args: Dict[str, Any],
                      correction: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        """The lr-free update of one parameter; advances its state.
        ``correction`` is its group's Adam bias corrections [2]."""
        kind = self.opt_type
        if kind == "adagrad":
            acc = state["sum"][name]
            acc.add_(g * g)
            return g / (acc.sqrt() + float(args.get("eps", 1e-10)))
        if kind in COUNTED:
            b1, b2 = _betas(args)
            eps = float(args.get("eps", 1e-8))
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(b1).add_((1 - b1) * g)
            mu_hat = mu / correction[0]
            if kind == "adamax":
                torch.maximum(g.abs() + eps, b2 * nu, out=nu)
                return mu_hat / nu
            nu.mul_(b2).add_((1 - b2) * (g * g))
            nu_hat = nu / correction[1]
            return mu_hat / (nu_hat.sqrt() + eps)
        if kind == "rmsprop":
            decay = float(args.get("alpha", 0.99))
            nu = state["nu"][name]
            nu.mul_(decay).add_((1 - decay) * (g * g))
            return torch.rsqrt(nu + float(args.get("eps", 1e-8))) * g
        if kind == "adadelta":
            rho, eps = float(args.get("rho", 0.9)), float(args.get("eps", 1e-6))
            e_g, e_x = state["e_g"][name], state["e_x"][name]
            e_g.mul_(rho).add_((1 - rho) * (g * g))
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.mul_(rho).add_((1 - rho) * (u * u))
            return u
        momentum = float(args.get("momentum", 0.0))
        if not momentum:
            return g
        trace = state["trace"][name]
        trace.mul_(momentum).add_(g)
        if args.get("nesterov", False):
            return g + momentum * trace
        return trace

    @torch.no_grad()
    def sparse_row_update(
            self, state: Dict[str, Dict[str, torch.Tensor]],
            rows: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
            lrs: Mapping[str, Any]):
        """The optimizer step on the touched rows of every sparse table of
        a step, in place: ``rows`` maps a table's name to ``(uniq,
        row_grads)``, its sorted row ids and their gradient rows (a run of
        equal ids carries its gradient at its last position). Each table
        keeps its group's ``lr`` (a float, or the 0-d device tensor the
        training job fills before each epoch, which the kernel reads on
        the device) and ``eps``. One launch of the row-update kernel for
        all tables on a card, its plain version on the host.
        Exact counterpart of torch sparse Adagrad / plain SGD on sparse
        gradients."""
        sgd = self.opt_type == "sgd"
        groups = [
            (self.params[name], None if sgd else state["sum"][name], uniq,
             row_grads, lrs[self.group_of[name]],
             self._arg(name, "eps", 1e-10))
            for name, (uniq, row_grads) in rows.items()]
        row_update_groups(self.opt_type, groups)

    # ------------------------------------------------------------------ state

    def opt_state_tree(self, state: Mapping[str, Mapping[str, Any]]
                       ) -> Dict[str, Any]:
        """``state`` in a tree of plain dicts whose leaves, flattened by
        ``tree_leaves`` (JAX's order), line up with those of ``kge_tpu``'s
        ``KgeOptimizer.init(params)``: ``{group: {slot: {path...}}}`` with
        the Adam family's ``count`` (an int32 scalar) in each group
        before ``mu`` and ``nu`` (optax's field order, which here is also
        the sorted order of the keys), and in a row-sparse run
        ``{"sparse": {path: {"sum": ...}}, "tx": {group: ...}}`` with the
        sparse tables under ``"sparse"`` only. Groups sort by name,
        parameters by path; optax's empty states, masked-out parameters
        and stateless transforms give no leaves."""
        dense: Dict[str, Any] = {
            g: {slot: {} for slot in self._slots(g)}
            for g in self.group_names}
        for g, count in state.get("count", {}).items():
            dense[g]["count"] = count
        sparse: Dict[str, Any] = {path: {} for path in self.sparse_paths}
        for name in self.params:
            for slot in self._slots(self.group_of[name]):
                if name not in state.get(slot, {}):
                    continue
                if name in self.sparse_paths:
                    sparse[name][slot] = state[slot][name]
                    continue
                dense[self.group_of[name]][slot][name] = state[slot][name]
        for g in self.group_names:
            for slot in self._slots(g):
                # nested by path; a list of layers stays a list, whose
                # leaves JAX takes in index order
                dense[g][slot] = nest(dense[g][slot])
        if self.sparse_paths:
            return {"sparse": sparse, "tx": dense}
        return dense

    def state_to_checkpoint(self, state: Dict[str, Dict[str, torch.Tensor]]
                            ) -> Dict[str, Any]:
        """The state as a checkpoint tree of numpy arrays (a sharded
        table's slots gathered whole: collective)."""
        def whole(name, v):
            module = self.sharded.get(name)
            if module is not None:
                v = fetch_global(v, module.mesh, True)
            return v.detach().cpu().numpy()

        return self.opt_state_tree({
            slot: {k: whole(k, v) for k, v in tensors.items()}
            for slot, tensors in state.items()})

    def load_state(self, state: Dict[str, Dict[str, torch.Tensor]],
                   opt_state: Any):
        """Copy a checkpoint's ``opt_state`` (written by either package,
        by a dense or a row-sparse run) into ``state``, leaf by leaf in
        JAX's order."""
        targets = tree_leaves(self.opt_state_tree({
            slot: {k: f"{slot}/{k}" for k in tensors}
            for slot, tensors in state.items()}))
        leaves = tree_leaves(opt_state)
        if len(leaves) != len(targets):
            raise ValueError(
                f"optimizer state in checkpoint has {len(leaves)} leaves, "
                f"expected {len(targets)} (optimizer config changed?)"
            )
        with torch.no_grad():
            for target_name, leaf in zip(targets, leaves):
                slot, key = target_name.split("/", 1)
                target = state[slot][key]
                array = np.asarray(leaf)
                module = self.sharded.get(key)
                if module is not None and slot != "count":
                    array = put_global(array, module.mesh, True)
                if tuple(array.shape) != tuple(target.shape):
                    raise ValueError(
                        f"optimizer state {slot} of {key} has shape "
                        f"{array.shape}, expected {tuple(target.shape)}"
                    )
                dtype = np.int32 if slot == "count" else np.float32
                target.copy_(torch.from_numpy(
                    np.asarray(array, dtype=dtype, order="C")))


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
