"""Training job base: the host epoch loop around one train step
(counterpart of ``kge_tpu/train/train.py``; reference: kge/job/train.py).

The epoch loop, validation, early stopping, learning-rate control and
checkpoint rotation follow ``kge_tpu``. The step is plain PyTorch on one
device: the subbatch losses (each divided by the true batch size) and
their backward passes, the penalty and its backward, then the optimizer
and the parameter constraints. Each subbatch (and the penalty) runs in a
training ``Ctx`` whose dropout generator is seeded from
``random_seed.torch``, the epoch, the step and the subbatch, so a resumed
run draws the masks of the uninterrupted one (the torch and JAX PRNG
streams differ: masks are held by their statistics, trajectories at
dropout 0). The model state (ConvE's batch-norm statistics) goes through
each step as in ``kge_tpu``: every subbatch reads the step's state, the
last subbatch's updates win, and checkpoints carry it. In a row-sparse run
(``_sparse_table_paths``) the loss reads the rows the strategy gathered
(``_step_context``) and the optimizer updates only those rows of the
tables. As in ``kge_tpu``, every batch is padded to
``train.batch_size`` with zero-weight rows.

The epoch keeps the device queue full: batches go up through pinned
memory without waiting, per-step metrics stay device tensors, and they
come back in one transfer when the epoch ends (NaN checks included).
``torch.profiler.record_function`` spans (``train.collate``,
``train.upload``, ``train.forward``, ``train.backward``,
``train.optimizer``, ``train.fetch``) name the phases a profile reads;
they cost nothing without a profiler.

``tpu.steps_per_dispatch`` (``_steps_per_dispatch``, as in ``kge_tpu``)
decides no dispatch here: the port runs one step a batch. It still
orders KvsAll's batches, which ``kge_tpu`` regroups into runs of one
compiled shape; the port draws the same order.

Under ``tpu.compute_dtype: bfloat16`` the embedders hand the scorers
bf16 embeddings in training (``LookupEmbedder._cast``); parameters,
gradients and optimizer state stay float32, and every loss casts its
scores to float32 first (``loss._Float32Loss``), as in ``kge_tpu``.

Not ported here: meshes and multi-host runs, grouped and device-resident
dispatch, the prefetch thread, row chunking and ``tpu.profile_dir``.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.train.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.train.loss import KgeLoss
from kge_tpu_torch.train.optimizer import KgeLRScheduler, KgeOptimizer
from kge_tpu_torch.utils.io import save_checkpoint
from kge_tpu_torch.utils.metric import Metric
from kge_tpu_torch.utils.misc import init_from, resolve_device
from kge_tpu_torch.utils.seed import (
    rng_seed_from_config, torch_generator_from_config
)
from kge_tpu_torch.utils.trace import format_trace_entry


def _refuse_unported(config: Config):
    """Raise on the ``tpu`` options whose paths are not ported; log the
    ones that change only how ``kge_tpu`` dispatches."""
    if max(config.get("tpu.mesh.data"), config.get("tpu.mesh.model")) > 1:
        raise NotImplementedError(
            "tpu.mesh (multi-device training) is not yet ported to "
            "kge_tpu_torch"
        )
    if config.get("tpu.multihost.enabled") == "on":
        raise NotImplementedError(
            "tpu.multihost is not yet ported to kge_tpu_torch")
    config.check("tpu.compute_dtype", ["float32", "bfloat16"])
    if config.get("tpu.profile_dir"):
        raise NotImplementedError(
            "tpu.profile_dir is not yet ported to kge_tpu_torch (profile "
            "with torch.profiler around the job)")
    depth = int(config.get("tpu.prefetch_batches"))
    if depth < 0:
        depth = min(2 * int(config.get("train.num_workers")), 8)
    if depth > 0:
        raise NotImplementedError(
            "batch prefetching (tpu.prefetch_batches, train.num_workers) is "
            "not yet ported to kge_tpu_torch")
    group = int(config.get("tpu.steps_per_dispatch"))
    if group > 1:
        config.log(f"tpu.steps_per_dispatch {group}: kge_tpu_torch runs one "
                   "step a batch in every trainer; KvsAll orders its batches "
                   f"in runs of up to {group} of one query type and label "
                   "width, as kge_tpu does")
    precision = config.check("tpu.matmul_precision",
                             ["default", "high", "highest"])
    if precision != "highest":
        config.log(f"tpu.matmul_precision {precision} is ignored: "
                   "kge_tpu_torch trains in full float32")


class TrainingJob(TrainingOrEvaluationJob):
    """Abstract base for training strategies."""

    def __init__(self, config: Config, dataset: Dataset, parent_job: Job = None,
                 model: Optional[KgeModel] = None, forward_only: bool = False):
        super().__init__(config, dataset, parent_job)
        self.device = resolve_device(config)
        _refuse_unported(config)
        # full float32, the counterpart of tpu.matmul_precision: highest
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.generator = torch_generator_from_config(config, self.device)
        #: dropout's generator, reseeded per subbatch (``_dropout_generator``)
        self._dropout_gen = torch_generator_from_config(config, self.device)
        self._torch_seed = rng_seed_from_config(config, "torch")
        if model is None:
            model = KgeModel.create(config, dataset, device=self.device,
                                    generator=self.generator)
        self.model = model
        self.model.normalize_params()
        self.loss = KgeLoss.create(config)
        self.batch_size: int = config.get("train.batch_size")
        self.subbatch_size: int = config.get("train.subbatch_size")
        self.train_split: str = config.get("train.split")
        self.is_forward_only = forward_only
        #: tables updated row-sparsely (``_sparse_table_paths``): autograd
        #: never sees them, only the rows a step gathers from them
        self._sparse_paths = () if forward_only else tuple(
            self._sparse_table_paths())
        # a forward-only job (the training_loss evaluation) may share the
        # model of a training job: it leaves the flags alone and steps
        # under no_grad
        if not forward_only:
            for name, p in self.model.named_parameters():
                p.requires_grad_(name not in self._sparse_paths)
        self.epoch = 0
        self.valid_trace: List[Dict[str, Any]] = []
        self.abort_on_nan: bool = config.get("train.abort_on_nan")
        self.type_str = "generic"
        self.post_valid_hooks: List[Callable] = []
        # kge_tpu's PRNG key (uint32[2]), kept for its checkpoints: the
        # port draws nothing from it (its dropout masks come from torch
        # generators); a resumed run passes the loaded one on unchanged
        self.rng = torch.randint(
            0, 2 ** 32, (2,), generator=self.generator, device=self.device,
            dtype=torch.int64,
        ).cpu().numpy().astype(np.uint32)

        self.optimizer = KgeOptimizer(
            config, dict(self.model.named_parameters()),
            sparse_paths=self._sparse_paths)
        self.opt_state = None if forward_only else self.optimizer.init()
        self.lr_scheduler = KgeLRScheduler(config)
        np_seed = rng_seed_from_config(config, "numpy")
        self._np_seed = np_seed
        self._np_rng = np.random.default_rng(np_seed if np_seed >= 0 else None)

        if not self.is_forward_only:
            from kge_tpu_torch.evaluation.eval import EvaluationJob

            valid_conf = config.clone()
            valid_conf.set("job.type", "eval")
            valid_conf.set(
                "eval.split",
                config.get("valid.split") or config.get("eval.split"),
            )
            valid_conf.set("eval.trace_level", config.get("valid.trace_level"))
            self.valid_job = EvaluationJob.create(
                valid_conf, dataset, parent_job=self, model=self.model
            )
        self.model.prepare_job(self)

    # ------------------------------------------------------------------ factory

    @staticmethod
    def create(config: Config, dataset: Dataset, parent_job: Job = None,
               model: Optional[KgeModel] = None,
               forward_only: bool = False) -> "TrainingJob":
        train_type = config.get("train.type")
        class_name = config.get_default(train_type + ".class_name")
        return init_from(
            class_name, config.modules(), config, dataset,
            parent_job=parent_job, model=model, forward_only=forward_only,
        )

    # ------------------------------------------------------------------ strategy API

    def _sparse_table_paths(self):
        """Dotted parameter names of the embedding tables whose updates
        are row-sparse in this strategy (overridden by negative sampling);
        () keeps the fully dense optimizer path."""
        return ()

    def _step_context(self, batch: Dict[str, Any]):
        """The step's training ``Ctx`` (the model state to read) and its
        gathered rows ``{table name: (uniq, rows)}`` (none here; negative
        sampling gathers them in a row-sparse run)."""
        return Ctx(train=True, state=self.model.model_state), {}

    def _dropout_generator(self, step: int, part: int) -> torch.Generator:
        """The generator of the dropout masks of one part of a step (a
        subbatch, or -1 for the penalty): seeded from
        ``random_seed.torch``, the epoch, the step and the part, so a
        resumed run draws the uninterrupted run's masks; an unseeded job
        draws from one stream."""
        if self._torch_seed >= 0:
            key = f"{self._torch_seed}/{self.epoch}/{step}/{part}".encode()
            digest = hashlib.blake2b(key, digest_size=8).digest()
            self._dropout_gen.manual_seed(
                int.from_bytes(digest, "little") >> 1)
        return self._dropout_gen

    def _part_context(self, ctx: Ctx, step: int, part: int) -> Ctx:
        """A fresh training Ctx for one part of a step: the step's state
        and tables, its own dropout generator, no updates yet."""
        return Ctx(train=True, generator=self._dropout_generator(step, part),
                   state=ctx.state, tables=ctx.tables)

    def _prepare(self):
        """Subclasses set self.num_examples and any precomputed indexes."""
        raise NotImplementedError

    def _generate_batches(self, epoch: int):
        """Yield per-batch numpy dicts (padded to static shapes)."""
        raise NotImplementedError

    def _epoch_np_rng(self, epoch: int) -> np.random.Generator:
        """Host RNG for epoch-scoped draws (batch order, negatives),
        derived from (seed, epoch): epoch k draws identically whether the
        run trained from epoch 1 or resumed at k-1, so a kill and resume
        reproduces the uninterrupted run. Unseeded jobs keep one
        stream."""
        if self._np_seed < 0:
            return self._np_rng
        return np.random.default_rng((self._np_seed, epoch))

    def _steps_per_dispatch(self) -> int:
        """``kge_tpu``'s group size of a dispatch: ``tpu.steps_per_dispatch``,
        or 1 where batch hooks must see every batch."""
        group = int(self.config.get("tpu.steps_per_dispatch"))
        if group <= 1:
            return 1
        if self.pre_batch_hooks or self.post_batch_hooks:
            return 1  # hooks observe real batch boundaries
        return group

    def _subbatch_loss(self, ctx: Ctx, batch: Dict[str, Any],
                       sub_slice: slice) -> torch.Tensor:
        """Loss sum of the given subbatch, already divided by batch size."""
        raise NotImplementedError

    def _penalty_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if "triples" in batch:
            return {"triples": batch["triples"]}
        return {}

    # ------------------------------------------------------------------ step

    def _subbatch_slices(self) -> List[slice]:
        size = self.batch_size
        sub = self.subbatch_size if self.subbatch_size > 0 else size
        return [slice(i, min(i + sub, size)) for i in range(0, size, sub)]

    def _step(self, batch: Dict[str, Any], lrs: Dict[str, float],
              step: int = 0) -> Dict[str, Any]:
        """One train step (the epoch's ``step``-th) on an uploaded batch;
        returns its metrics as device tensors (no host sync)."""
        slices = self._subbatch_slices()
        if self.is_forward_only:
            ctx, _ = self._step_context(batch)
            with torch.no_grad(), record_function("train.forward"):
                total = sum(
                    self._subbatch_loss(self._part_context(ctx, step, i),
                                        batch, sl)
                    for i, sl in enumerate(slices))
            return {"avg_loss": total, "avg_penalty": 0.0, "avg_cost": total}

        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        with record_function("train.forward"):
            ctx, rows = self._step_context(batch)
        total_loss = 0.0
        updates: Dict[str, Any] = {}
        for i, sl in enumerate(slices):
            with record_function("train.forward"):
                part = self._part_context(ctx, step, i)
                value = self._subbatch_loss(part, batch, sl)
            if isinstance(value, torch.Tensor):
                if value.requires_grad:
                    with record_function("train.backward"):
                        value.backward()
                value = value.detach()
            total_loss = total_loss + value
            # the last subbatch's state updates win (kge_tpu's merge)
            updates.update(part.updates)

        with record_function("train.forward"):
            terms = self.model.penalties(
                self._part_context(ctx, step, -1),
                batch=self._penalty_batch(batch)
            )
            penalty_total = 0.0
            for _, v in terms:
                penalty_total = penalty_total + v
        if terms:
            with record_function("train.backward"):
                penalty_total.backward()
            penalty_total = penalty_total.detach()
        with record_function("train.optimizer"):
            self.optimizer.step(self.opt_state, lrs)
            # every sparse table of the step in one call: one launch of
            # the row-update kernel on a card
            if rows:
                self.optimizer.sparse_row_update(
                    self.opt_state,
                    {name: (uniq, gathered.grad)
                     for name, (uniq, gathered) in rows.items()}, lrs)
            self.model.normalize_params()
        if updates:
            self.model.model_state = {**self.model.model_state, **updates}
        return {
            "avg_loss": total_loss,
            "avg_penalty": penalty_total,
            "avg_cost": total_loss + penalty_total,
            **{f"avg_penalty_{k}": v.detach() for k, v in terms},
        }

    # ------------------------------------------------------------------ run

    def run(self) -> Dict[str, Any]:
        """Epoch loop with validation, early stopping, LR scheduling, and
        checkpoint rotation (reference: kge/job/train.py:139-254)."""
        if not self._is_prepared:
            self._prepare()
            self._is_prepared = True

        for f in self.pre_run_hooks:
            f(self)

        self.config.log(f"Starting training ({self.type_str})...")
        checkpoint_every = self.config.get("train.checkpoint.every")
        checkpoint_keep = self.config.get("train.checkpoint.keep")
        metric_name = self.config.get("valid.metric")
        patience = self.config.get("valid.early_stopping.patience")

        if (self.epoch == 0 and not self.is_forward_only
                and self.config.folder):
            self._save(self.config.checkpoint_file(0))

        while True:
            # should we stop?
            if self.epoch >= self.config.get("train.max_epochs"):
                self.config.log("Maximum number of epochs reached.")
                break
            if len(self.valid_trace) > 0 and patience > 0:
                values = [t[metric_name] for t in self.valid_trace]
                # stop when the best value FIRST occurred more than
                # `patience` validations ago (reference best_index)
                best_idx = Metric(self).best_index(values)
                if (len(values) > patience
                        and best_idx < len(values) - patience):
                    self.config.log(
                        f"Stopping early ({patience} validations without "
                        "improvement)."
                    )
                    break
            th_epochs = self.config.get(
                "valid.early_stopping.threshold.epochs"
            )
            if len(self.valid_trace) > 0 and th_epochs > 0:
                th_value = self.config.get(
                    "valid.early_stopping.threshold.metric_value"
                )
                best = Metric(self).best(
                    [t[metric_name] for t in self.valid_trace]
                )
                if self.epoch >= th_epochs and Metric(self).better(
                    th_value, best
                ):
                    self.config.log(
                        "Stopping early (threshold not reached)."
                    )
                    break

            # run one epoch
            self.epoch += 1
            self.config.log(f"Starting epoch {self.epoch}...")
            self.run_epoch()
            self.config.log(f"Finished epoch {self.epoch}.")

            # validate
            if (not self.is_forward_only
                    and self.config.get("valid.every") > 0
                    and self.epoch % self.config.get("valid.every") == 0):
                self.valid_job.epoch = self.epoch
                valid_entry = self.valid_job.run()
                self.valid_trace.append(valid_entry)
                for f in self.post_valid_hooks:
                    f(self)
                metric_value = valid_entry[metric_name]
                self.lr_scheduler.step(metric_value)
                # save best checkpoint
                best = Metric(self).best(
                    [t[metric_name] for t in self.valid_trace]
                )
                if metric_value == best and self.config.folder:
                    self._save(self.config.checkpoint_file("best"))
            elif not self.is_forward_only:
                self.lr_scheduler.step(None)

            # checkpoint rotation (reference: train.py:236-254)
            if not self.is_forward_only and self.config.folder:
                self._save(self.config.checkpoint_file(self.epoch))
                self._delete_obsolete_checkpoints(
                    checkpoint_every, checkpoint_keep
                )

        self.trace(event="train_completed", epoch=self.epoch)
        result = self.current_trace["epoch"] or {}
        for f in self.post_run_hooks:
            f(self, result)
        return result

    def _delete_obsolete_checkpoints(self, every: int, keep: int):
        if not self.config.folder:
            return
        keep_init = self.config.get("train.checkpoint.keep_init")
        for e in range(1 if keep_init else 0, self.epoch):
            keep_this = (
                every > 0 and e % every == 0
                and e > self.epoch - every * keep - 1
            )
            if not keep_this:
                path = self.config.checkpoint_file(e)
                if os.path.isfile(path):
                    os.remove(path)

    def run_epoch(self) -> Dict[str, Any]:
        """One epoch, one step per batch (the host-collate loop of
        ``kge_tpu``)."""
        for f in self.pre_epoch_hooks:
            f(self)
        lr_scale = self.lr_scheduler.lr_scale(self.epoch)
        lrs = {g: base * lr_scale
               for g, base in self.optimizer.base_lrs.items()}

        epoch_start = time.time()
        batch_metrics = []
        num_batches = 0
        prepare_time = 0.0
        batches = iter(self._generate_batches(self.epoch))
        while True:
            with record_function("train.collate"):
                batch_np = next(batches, None)
            if batch_np is None:
                break
            for f in self.pre_batch_hooks:
                f(self)
            t0 = time.time()
            with record_function("train.upload"):
                batch = self._put_batch(batch_np)
            prepare_time += time.time() - t0
            metrics = self._step(batch, lrs, num_batches)
            batch_metrics.append((float(batch_np["size"]), metrics))
            num_batches += 1
            for f in self.post_batch_hooks:
                f(self)
        return self._finish_epoch(
            batch_metrics, num_batches, prepare_time, epoch_start
        )

    def _finish_epoch(self, batch_metrics, num_batches: int,
                      prepare_time: float, epoch_start: float
                      ) -> Dict[str, Any]:
        """Fetch the epoch's metrics (one transfer), aggregate, trace."""
        with record_function("train.fetch"):
            device_values = [v for _, m in batch_metrics for v in m.values()
                             if isinstance(v, torch.Tensor)]
            fetched = iter(
                torch.stack(device_values).cpu().double().tolist()
                if device_values else ()
            )
            batch_metrics = [
                (size, {k: next(fetched) if isinstance(v, torch.Tensor)
                        else float(v) for k, v in m.items()})
                for size, m in batch_metrics
            ]
        # avg_* epoch metrics are example-weighted batch averages:
        # sum(batch_avg * true_batch_size) / num_examples, so a short tail
        # batch does not skew the epoch average
        sums: Dict[str, float] = {}
        total_size = 0.0
        for size, metrics in batch_metrics:
            total_size += size
            for key, v in metrics.items():
                sums[key] = sums.get(key, 0.0) + v * size
        epoch_time = time.time() - epoch_start

        if self.abort_on_nan and not math.isfinite(sums.get("avg_cost", 0.0)):
            raise FloatingPointError("training cost became NaN")

        trace_entry = dict(
            type=self.type_str,
            scope="epoch",
            epoch=self.epoch,
            split=self.train_split,
            batches=num_batches,
            size=self.num_examples,
            epoch_time=epoch_time,
            prepare_time=prepare_time,
            event="epoch_completed",
            **{k: v / max(total_size, 1.0) for k, v in sums.items()},
        )
        self.current_trace["epoch"] = trace_entry
        for f in self.post_epoch_hooks:
            f(self)
        self.trace(**trace_entry, echo=False, log=True)
        line = format_trace_entry("train_epoch", trace_entry, self.config)
        if line:
            self.config.log(line)
        if self.config.get("train.trace_level") == "batch":
            for batch_index, (_, metrics) in enumerate(batch_metrics):
                self.trace(type=self.type_str, scope="batch",
                           epoch=self.epoch, batch=batch_index, **metrics)
        return trace_entry

    # ------------------------------------------------------------------ checkpoints

    def _save(self, filename: str):
        if self.config.folder is None:
            return
        self.config.log(f"Saving checkpoint to {filename}...")
        checkpoint = {
            "type": "train",
            "epoch": self.epoch,
            "valid_trace": self.valid_trace,
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "job_id": self.job_id,
            "rng": np.asarray(self.rng),
            "opt_state": (None if self.opt_state is None else
                          self.optimizer.state_to_checkpoint(self.opt_state)),
        }
        self.model.save_to(checkpoint)
        self.config.save_to(checkpoint)
        self.dataset.save_to(checkpoint)
        save_checkpoint(filename, checkpoint)

    def _load(self, checkpoint: Dict[str, Any]):
        if checkpoint["type"] != "train":
            raise ValueError("training can only be continued from trained models")
        self.model.load_params(checkpoint["model"]["params"])
        self.model.load_state(checkpoint["model"].get("state", {}))
        if checkpoint.get("opt_state") is not None and not self.is_forward_only:
            self.optimizer.load_state(self.opt_state, checkpoint["opt_state"])
        self.epoch = checkpoint["epoch"]
        self.valid_trace = checkpoint["valid_trace"]
        if "lr_scheduler" in checkpoint:
            self.lr_scheduler.load_state_dict(checkpoint["lr_scheduler"])
        if "rng" in checkpoint:
            self.rng = np.asarray(checkpoint["rng"])
        self.resumed_from_job_id = checkpoint.get("job_id")
        self.trace(
            event="job_resumed", epoch=self.epoch,
            checkpoint_file=checkpoint.get("file"),
        )

    def _put_batch(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Host batch -> device. Arrays go up through pinned memory without
        waiting for queued work (integer arrays as int64 index tensors);
        scalars (the true size, the number of unique negatives) stay on
        the host as Python numbers."""
        out: Dict[str, Any] = {}
        for key, value in batch_np.items():
            if np.ndim(value) == 0:
                out[key] = value.item()
                continue
            array = np.asarray(value)
            if array.dtype.kind in "iu":
                array = array.astype(np.int64)
            tensor = torch.from_numpy(np.ascontiguousarray(array))
            if self.device.type == "cuda":
                tensor = tensor.pin_memory().to(self.device, non_blocking=True)
            out[key] = tensor
        return out

    # ------------------------------------------------------------------ batching helpers

    def _pad_batch_indexes(self, order: np.ndarray):
        """Yield (indexes[batch_size], weights[batch_size], true_size)."""
        n = len(order)
        for start in range(0, n, self.batch_size):
            chunk = order[start : start + self.batch_size]
            true = len(chunk)
            if true < self.batch_size:
                pad = np.zeros(self.batch_size - true, dtype=chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            weights = np.zeros(self.batch_size, dtype=np.float32)
            weights[:true] = 1.0
            yield chunk, weights, true
