"""The training mix: the window drives the trainer's epoch loop
(``TrainingJob.run_epoch``, as the job's ``run`` drives it) over the
synthetic graph, epoch after epoch, without validation, checkpoints or
batch hooks.

Set-up builds the one job the window runs, loads the benchmark's
weights into it, and drives it through its first ``check_steps`` steps
by the window's own call and feed (the first host batches of epoch 1).
Those steps are recorded for the reference (their inputs, the state of
the dropout generator at each dropout site, each step's loss, the
optimizer's state after the first step, the leaves after the first and
the last), then a warm-up (``warmup_steps`` host batches) and the
window.

An epoch that would outlast the window ends at the window's close: its
batch generator stops yielding there, and the steps already queued
finish before the epoch's one fetch. A device-resident epoch runs whole.
Neither changes a decision the program takes (group size, capture,
sampling or order).

Program names this relies on: ``TrainingJob.create``, ``_prepare``,
``_is_prepared``, ``run_epoch``, ``epoch``, ``_generate_batches``,
``_epoch_device_payload``, ``_step``, ``_dispatch_group``,
``graph_replays``, ``_dropout_gen``, ``opt_state``, ``model``,
``models.api.Ctx.dropout`` and ``Ctx.generator``, and
``KgeRgnnModel._encode`` (wrapped in a ``portbench.encode`` span in traced
runs)."""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness.cell import CACHE, phase
from harness.graph import dataset_folder
from harness.weights import draw
from models.common import Products


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never on a
    build or a machine without CUDA)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def philox_offset(state: torch.Tensor) -> int:
    """The Philox offset of a CUDA generator's state (its last 8 bytes;
    the 8 before them hold the seed)."""
    return int(state[-8:].view(torch.int64)[0])


def at_offset(state: torch.Tensor, offset: int) -> torch.Tensor:
    """``state`` with its Philox offset set to ``offset``."""
    out = state.clone()
    out[-8:] = torch.tensor([offset], dtype=torch.int64).view(torch.uint8)
    return out


class Recorder:
    """Wraps the job's feed, steps and groups of steps, and
    ``Ctx.dropout``, for the check steps: the first ``n`` host batches of
    the epoch, at each dropout site of each step the state of the
    generator the program draws its mask from and the shape it draws,
    each step's loss, the optimizer's state and the leaves after the
    first step. It takes no mask from the program: the reference draws
    its own.

    A group the program replays as a CUDA graph calls no step: its steps'
    losses are the rows of the ``[k, n]`` values it returns, and their
    draws are the eager group of the same key's, each moved by the
    Philox offset the generator held when the replay began (a replay
    draws what eager steps would: the generator is registered with the
    graph, which a capture does not advance). A capture runs nothing, so
    the wrappers pass it straight through and record nothing."""

    def __init__(self, job, n: int):
        self.job, self.n = job, n
        self.batches: List[Dict] = []
        self.losses: List = []
        self.draws: List[List] = []
        self.state1 = None
        self.params1 = None
        self._step_draws = None
        #: by group key, the generator's state at the start of the last
        #: eager group of that key and the draws of its steps
        self._eager: Dict = {}

    def __enter__(self):
        from kge_tpu_torch.models.api import Ctx

        job, rec = self.job, self
        gen, step = job._generate_batches, job._step
        dispatch = job._dispatch_group

        def generate(epoch):
            for batch in itertools.islice(gen(epoch), rec.n):
                rec.batches.append({k: np.array(v) for k, v in batch.items()})
                yield batch

        def stepped(batch, lrs, correction=None):
            if capturing():
                return step(batch, lrs, correction)
            rec._step_draws = []
            out = step(batch, lrs, correction)
            rec.draws.append(rec._step_draws)
            rec._step_draws = None
            rec.losses.append(out["avg_loss"].clone())
            if rec.state1 is None:
                rec.state1 = {slot: {k: v.clone() for k, v in leaves.items()}
                              for slot, leaves in job.opt_state.items()
                              if slot != "count"}
                rec.params1 = {n: p.detach().clone()
                               for n, p in job.model.named_parameters()}
            return out

        def dispatched(key, host, run):
            if capturing():
                return dispatch(key, host, run)
            start = job._dropout_gen.get_state()
            first, replays = len(rec.draws), job.graph_replays
            names, values = dispatch(key, host, run)
            if job.graph_replays == replays:
                rec._eager[key] = (start, rec.draws[first:])
            else:
                rec._replayed(key, start, names, values)
            return names, values

        self._dropout = Ctx.dropout

        def dropout(ctx, x, rate, replicated=False):
            if (rec._step_draws is not None and ctx.train and rate > 0
                    and ctx.generator is not None and not capturing()):
                rec._step_draws.append(dict(
                    state=ctx.generator.get_state(), shape=tuple(x.shape),
                    dtype=x.dtype, device=x.device))
            return rec._dropout(ctx, x, rate, replicated)

        job._generate_batches, job._step = generate, stepped
        job._dispatch_group = dispatched
        Ctx.dropout = dropout
        return self

    def _replayed(self, key, start: torch.Tensor, names: List[str],
                  values: torch.Tensor):
        """Records of a replayed group's steps: each loss from its row of
        ``values``, each draw the same key's eager draw at its offset from
        that group's start, moved to this group's ``start``."""
        if key not in self._eager:
            raise RuntimeError(f"group {key!r} was replayed before it ran "
                               "eagerly under the recorder")
        eager_start, eager_draws = self._eager[key]
        base, now = philox_offset(eager_start), philox_offset(start)
        loss = values[:, names.index("avg_loss")]
        for i, draws in enumerate(eager_draws):
            self.losses.append(loss[i])
            self.draws.append([
                dict(d, state=at_offset(
                    start, now + philox_offset(d["state"]) - base))
                for d in draws])

    def __exit__(self, *exc):
        from kge_tpu_torch.models.api import Ctx

        Ctx.dropout = self._dropout
        for name in ("_generate_batches", "_step", "_dispatch_group"):
            del self.job.__dict__[name]
        self.losses = [float(x) for x in self.losses[:self.n]]
        self.draws = self.draws[:self.n]


@contextlib.contextmanager
def bounded(job, deadline=None, steps=None, counter=None):
    """The epoch's host batches end at ``deadline`` (the host clock) or
    after ``steps`` batches; ``counter`` counts the steps and examples
    fed, a device-resident epoch's whole."""
    gen, payload = job._generate_batches, job._epoch_device_payload

    def generate(epoch):
        source = gen(epoch)
        if steps is not None:
            source = itertools.islice(source, steps)
        for batch in source:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            if counter is not None:
                counter["steps"] += 1
                counter["examples"] += float(batch["size"])
            yield batch

    def resident(epoch):
        out = payload(epoch)
        if out is not None and counter is not None:
            counter["steps"] += len(out["size"])
            counter["examples"] += float(np.sum(out["size"]))
        return out

    job._generate_batches, job._epoch_device_payload = generate, resident
    try:
        yield
    finally:
        del job.__dict__["_generate_batches"]
        del job.__dict__["_epoch_device_payload"]


@contextlib.contextmanager
def encode_span(model):
    """A ``portbench.encode`` span around an R-GNN model's encoder entry,
    put from the benchmark's files (the program has none there)."""
    encode = getattr(model, "_encode", None)
    if encode is None:
        yield
        return
    from torch.profiler import record_function

    def spanned(ctx):
        with record_function("portbench.encode"):
            return encode(ctx)

    model._encode = spanned
    try:
        yield
    finally:
        del model.__dict__["_encode"]


class Run:
    def __init__(self, cell, seed: int, device: str):
        from kge_tpu_torch import Dataset
        from kge_tpu_torch.train.train import TrainingJob

        phase("imports")
        self.cell, self.device = cell, device
        mix, conf = cell.mix, cell.config
        folder, self.splits = dataset_folder(
            os.path.join(CACHE, "data"), conf["name"], conf["graph"],
            conf["graph_seed"], seed)
        phase("graph")
        config = cell.program_config(folder, seed, device,
                                     mix.get("program", {}))
        dataset = Dataset.create(config, folder)
        job = TrainingJob.create(config, dataset)
        phase("job")
        shapes = {n: tuple(p.shape) for n, p in job.model.named_parameters()}
        self.weights = draw(shapes, conf["weights"], conf["graph"], seed,
                            device)
        with torch.no_grad():
            for name, p in job.model.named_parameters():
                p.copy_(self.weights[name])
        job._prepare()
        job._is_prepared = True
        self.job = job
        phase("weights")
        self.batch_size = int(config.get("train.batch_size"))

        # the check steps: the first steps of epoch 1, recorded
        job.epoch = 1
        with Recorder(job, int(mix["check_steps"])) as rec:
            job.run_epoch()
        self.record = rec
        phase("check steps")
        self.after = {n: p.detach().clone()
                      for n, p in job.model.named_parameters()}
        # the warm-up: host batches
        job.epoch = 2
        with bounded(job, steps=int(mix["warmup_steps"])):
            job.run_epoch()
        _sync(device)
        phase("warm-up")

    def window(self, seconds: float, traced: bool = False) -> Dict:
        job = self.job
        counter = {"steps": 0, "examples": 0.0}
        spans = encode_span(job.model) if traced else contextlib.nullcontext()
        _sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with spans, bounded(job, deadline=deadline, counter=counter):
            while True:
                job.epoch += 1
                job.run_epoch()
                if time.perf_counter() >= deadline:
                    break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        step_flops = self.cell.model.train_step_flops(self.cell.config,
                                                      self.batch_size)
        return dict(window_s=window_s, steps=counter["steps"],
                    examples=counter["examples"],
                    flops=step_flops * counter["steps"], facts={})

    def check(self, control: bool = False) -> List:
        """Free the program, follow the check steps with the reference,
        and return ``[name, value, limit]`` of every number (the limit
        None where the configuration compares it to nothing; PERF.md says
        why). ``control``: the reference on TF32-rounded operands in the
        program's place."""
        rec = self.record
        self.job = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        model = self.cell.model.build(self.cell.config, self.splits)
        model.to(torch.device(self.device))
        limits = self.cell.limits
        try:
            steps = self.cell.model.reference_steps(rec)
            want = model.train(self.weights, steps, Products())
            if control:
                got = model.train(self.weights, steps, Products(tf32=True))
            else:
                got = (rec.losses, first_grads(rec.state1), rec.params1,
                       self.after)
        except (RuntimeError, ValueError) as e:
            # what the program recorded does not fit the model: no number
            print(f"portbench: the reference cannot follow the recorded "
                  f"steps: {e}", file=sys.stderr)
            return [[name, float("inf"), limit]
                    for name, limit in limits.items()]
        numbers = compare(got, want, self.weights)
        numbers["input_faults"] = model.input_faults(steps)
        return [[name, value, limits.get(name)]
                for name, value in numbers.items()]


def compare(got, want, start: Dict[str, torch.Tensor]) -> Dict:
    """The numbers a training cell compares: (losses, first gradients,
    leaves after the first step, leaves after the last) of the program
    (or the control) against the reference's, each leaf's gap over the
    larger of its own reference norm and the median leaf's. Leaves whose
    first reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out.

    ``first_step_gap`` is the one that reads the update's sign: the gap of
    the leaves after the first step, over the elements whose first
    gradient has the same sign on both sides. Adam's first update is
    about ``-lr * sign(g)``, so an element whose gradient is zero to
    rounding may step the other way in a sound program; one whose
    gradient agrees in sign may not."""
    losses, grads, first, last = got
    ref_losses, ref_grads, ref_first, ref_last = want

    def grad(k):
        return grads.get(k, torch.zeros_like(start[k]))

    norm = {k: float(torch.linalg.norm(ref_grads[k])) if k in ref_grads
            else 0.0 for k in start}
    median = sorted(norm.values())[len(norm) // 2]
    kept = [k for k in start if norm[k] >= 1e-3 * median]
    zero = torch.zeros(())

    def gaps(values):
        scale = sorted(float(r) for _, r in values.values())
        mid = scale[len(scale) // 2]
        return {k: float(v) / max(float(r), mid, 1e-30)
                for k, (v, r) in values.items()}

    gap = gaps({k: (abs(torch.linalg.norm(grads.get(k, zero))
                        - norm[k]), norm[k]) for k in kept})
    diff = gaps({k: (torch.linalg.norm(grad(k) - ref_grads[k]), norm[k])
                 for k in kept})
    agree = {k: torch.sign(grad(k)) == torch.sign(ref_grads[k])
             for k in kept}
    step = gaps({k: (torch.linalg.norm((first[k] - ref_first[k])[agree[k]]),
                     float(torch.linalg.norm(
                         (ref_first[k] - start[k])[agree[k]])))
                 for k in kept})
    change = {k: (float(torch.linalg.norm(last[k] - start[k])),
                  float(torch.linalg.norm(ref_last[k] - start[k])))
              for k in kept}
    change = gaps({k: (abs(a - b), b) for k, (a, b) in change.items()})
    flips = sum(int(torch.count_nonzero(
        (torch.sign(first[k] - start[k]) * torch.sign(ref_first[k] - start[k]))
        < 0)) for k in kept)
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses):
        steps = [float("inf")]
    return {
        "first_loss_gap": steps[0],
        "loss_gap": max(steps),
        "grad_gap": max(gap.values()),
        "grad_diff": max(diff.values()),
        "first_step_gap": max(step.values()),
        "change_gap": max(change.values()),
        "median_change_gap": sorted(change.values())[len(change) // 2],
        "first_update_flips": flips,
        "worst_change_leaf": max(change, key=change.get),
    }


def first_grads(state1: Dict) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient from Adam's state after one step: its
    first moment is then (1 - b1) g."""
    return {k: v / 0.1 for k, v in state1["mu"].items()}
