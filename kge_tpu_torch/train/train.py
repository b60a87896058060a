"""Training job base: the host epoch loop around one train step
(counterpart of ``kge_tpu/train/train.py``; reference: kge/job/train.py).

The epoch loop, validation, early stopping, learning-rate control and
checkpoint rotation follow ``kge_tpu``. The step is plain PyTorch on one
device: the subbatch losses (each divided by the true batch size) and
their backward passes, the penalty and its backward, then the optimizer
and the parameter constraints. Each subbatch (and the penalty) runs in a
training ``Ctx`` that draws its dropout masks from the job's dropout
generator, seeded once an epoch from ``random_seed.torch`` and the epoch
(``_seed_generators``), so a resumed run draws the masks of the
uninterrupted one, and grouped steps draw what the same steps one by one
would (the torch and JAX PRNG streams differ: masks are held by their
statistics, trajectories at dropout 0). The model state (ConvE's
batch-norm statistics) goes through each step as in ``kge_tpu``: every
subbatch reads the step's state, the last subbatch's updates win, and
they are copied into the state's tensors in place (``copy_state``), so
those tensors stay where a captured graph and the evaluation read them;
checkpoints carry it. In a row-sparse run
(``_sparse_table_paths``) the loss reads the rows the strategy gathered
(``_step_context``) and the optimizer updates only those rows of the
tables. As in ``kge_tpu``, every batch is padded to
``train.batch_size`` with zero-weight rows.

The epoch keeps the device queue full: batches go up through pinned
memory without waiting, per-step metrics stay device tensors, and they
come back in one transfer when the epoch ends (NaN checks included).
``torch.profiler.record_function`` spans (``train.collate``,
``train.upload``, ``train.forward``, ``train.backward``,
``train.optimizer``, ``train.replay``, ``train.fetch``) name the phases
a profile reads;
they cost nothing without a profiler. An R-GNN encoder adds its own
(``models/rgnn``): ``train.encode`` inside ``train.forward``, with
``train.encode.messages`` and ``train.encode.aggregate`` inside it, and,
while a profiler records, ``train.encode.backward`` on autograd's
thread. ``tpu.profile_dir`` traces epoch 1 with ``torch.profiler`` and
writes a Chrome trace into that folder.

Grouped dispatch (``tpu.steps_per_dispatch``, as ``kge_tpu``'s
``_run_epoch_inner``): batches of one structure (``signature``) are
taken in groups of k; a shorter tail runs batch by batch. A strategy
whose whole epoch is a small payload (on-device negative sampling:
``_epoch_device_payload``) uploads it once, and each group then reads
its batches from it at a start index (``_expand_device_batch`` draws the
rest on the device). On a card a group of k steps is captured once per
(signature, k) into a ``torch.cuda.CUDAGraph`` and replayed: the first
group of a job runs eagerly on the capture stream (its warm-up: autograd,
the cuBLAS workspace of that stream, the kernels' attributes), the next
ones replay the graph after their inputs were copied into its buffers.
Learning rates are device tensors filled before each epoch (the
row-update kernel of a row-sparse step reads its rate there too), the
Adam family's bias corrections go up with each group, the sampling and
dropout generators are registered with each graph (replays draw what
the eager steps would), the model state is updated in place, a
row-sparse step's row payload goes into the graph's buffers with the
rest of the batch, and the kernel launch counters gain a graph's
captured launches on each replay (the spectral route's ``ccorr_reduce``
among them). An R-GNN encoder on a fixed graph is captured too: its
graph's tensors stay where the capture read them, its forward's memo
lives in each step's ``Ctx``, and the captured groups are dropped when
the encoder rebuilds its graph (``graph_version``). A replay is the span
``train.replay``; ``replayed_batches`` counts the epoch's batches that
ran inside one, and a capturing job logs it with each epoch.
``_capture_unsupported_reasons`` is the predicate that keeps a job's
groups eager (logged once): graph sampling (a new graph every epoch)
and a device mesh (its collectives). Such groups, and every group on
the CPU, run their k steps eagerly with the same math. A capture or
replay that fails raises.
``_prefetch`` runs the batch generator in a producer thread
(``tpu.prefetch_batches``, ``train.num_workers``); its draws and order
are the serial loop's.

Under ``tpu.compute_dtype: bfloat16`` the embedders hand the scorers
bf16 embeddings in training (``LookupEmbedder._cast``); parameters,
gradients and optimizer state stay float32, and every loss casts its
scores to float32 first (``loss._Float32Loss``), as in ``kge_tpu``.

Under a device mesh (``tpu.mesh``; ``parallel/``) each process is one
device of the (data, model) mesh, as ``kge_tpu``'s ``_put_batch`` and
``params_sharding`` lay it out: every rank draws the whole global batch
from the same generators (an unseeded run's seeds come from rank 0) and
computes the rows of its ``data`` block of every part of the step
(``_parts``: a ``BatchShard`` in each part's ``Ctx``); every loss term
is already divided by the global batch, so the data group's sum of the
ranks' losses and gradients is the global batch's (one ``all_reduce``
of the step's gradients, ``_reduce_gradients``). Embedding tables are
stored as row blocks over ``model`` (``LookupEmbedder``), and their
optimizer state with them; every model rank computes the replicated
parameters' gradients whole, equal up to the order of a card's atomic
sums, and their mean over the model group keeps the ranks' copies equal
bit for bit (``_average_over_model``). Penalties are computed whole on every rank
and divided by the data axis before their backward, so the sum counts
them once; the epoch's metrics are summed over the data group in its one
fetch. ``train.batch_size`` rounds up to divide the data axis. Rank 0
alone writes checkpoints (gathered from the shards by every rank, then a
barrier); the other ranks log to ``<folder>/proc<i>/``. Steps under a
mesh run eagerly (``_capture_unsupported_reasons``: their collectives are
not captured).

Not ported here: row chunking.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.models.api import BatchShard, copy_state
from kge_tpu_torch.ops.ccorr_reduce import ccorr_reduce
from kge_tpu_torch.ops.negsamp_loss import shared_ce_loss
from kge_tpu_torch.ops.row_update import adagrad_row_update, sgd_row_update
from kge_tpu_torch.parallel import distributed as dist
from kge_tpu_torch.parallel import mesh as mesh_lib
from kge_tpu_torch.train.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.train.loss import KgeLoss
from kge_tpu_torch.train.optimizer import KgeLRScheduler, KgeOptimizer
from kge_tpu_torch.utils.io import save_checkpoint
from kge_tpu_torch.utils.metric import Metric
from kge_tpu_torch.utils.misc import init_from, resolve_device, to_device
from kge_tpu_torch.utils.seed import (
    derived_seed, rng_seed_from_config, torch_generator_from_config
)
from kge_tpu_torch.utils.trace import format_trace_entry

#: the counted kernel wrappers a captured step can call (``launches``):
#: the fused loss, the row updates and the spectral route's reduce; a
#: graph replay adds the launches its capture recorded
COUNTED_KERNELS = (shared_ce_loss, adagrad_row_update, sgd_row_update,
                   ccorr_reduce)


def _prefetch(gen, depth: int):
    """Run a batch generator in a producer thread so host collate
    (sampling, label coordinates) overlaps the device's work (``kge_tpu``'s
    ``_prefetch``). Single producer, single consumer: the order and the
    generators' draws are the serial loop's."""
    if depth <= 0:
        yield from gen
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    errors = []

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone (an
        abandoned epoch must not leave this thread blocked for ever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            errors.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        try:  # unblock a producer mid-put
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join()


class _Graph(NamedTuple):
    """One captured group: the graph, the buffers its inputs are copied
    into before a replay, its metric names and output, and the kernel
    launches it holds."""
    graph: Any
    inputs: Dict[str, torch.Tensor]
    names: List[str]
    out: torch.Tensor
    launches: List[Tuple[Any, int]]


def _join_process_group(config: Config):
    """``kge_tpu``'s multi-process bootstrap: join the process group
    (``tpu.multihost``), check that every rank has a folder or none,
    send the other ranks' logs to ``<folder>/proc<i>/``, and make an
    unseeded run's seeds rank 0's (every rank draws the global batch)."""
    dist.maybe_init_from_config(config)
    if dist.process_count() <= 1:
        return
    flags = dist.all_flags(1 if config.folder else 0)
    if min(flags) != max(flags):
        raise ValueError(
            "multi-host runs must set a folder on every process "
            "or on none (use one SHARED folder: process 0 writes "
            "checkpoints, every process resumes from it)"
        )
    dist.use_rank_log_folder(config)
    config.log(f"Joined the process group as rank {dist.process_index()} of "
               f"{dist.process_count()} ({dist.backend()} backend: "
               f"{dist.backend_reason()})")
    for name in ("torch", "numpy"):
        seed = rng_seed_from_config(config, name)
        agreed = dist.broadcast_int(
            seed if seed >= 0 else int.from_bytes(os.urandom(4), "little"))
        if seed < 0:
            config.set(f"random_seed.{name}", agreed)


def _check_tpu_options(config: Config):
    """Log the ``tpu`` options that change nothing here."""
    config.check("tpu.compute_dtype", ["float32", "bfloat16"])
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
        _join_process_group(config)
        self.device = resolve_device(config)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)  # NCCL's current card
        _check_tpu_options(config)
        self.batch_size: int = config.get("train.batch_size")
        #: the device mesh (one rank a device), None on one device
        self.mesh = mesh_lib.build_mesh(config)
        if self.mesh is not None:
            data_size = self.mesh.shape["data"]
            if self.batch_size % data_size != 0:
                new_size = -(-self.batch_size // data_size) * data_size
                config.log(
                    f"Rounding train.batch_size up to {new_size} to divide "
                    f"the data mesh axis ({data_size})."
                )
                self.batch_size = new_size
                config.set("train.batch_size", new_size)
            config.log(f"Using mesh {self.mesh.shape} over "
                       f"{self.mesh.size} devices")
        mesh_lib.set_active(self.mesh)
        # full float32, the counterpart of tpu.matmul_precision: highest
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.generator = torch_generator_from_config(config, self.device)
        #: the generators of dropout's masks and of the draws made on the
        #: device (negatives), reseeded per epoch (``_seed_generators``)
        self._dropout_gen = torch_generator_from_config(config, self.device)
        self._sampling_gen = torch_generator_from_config(config, self.device)
        self._torch_seed = rng_seed_from_config(config, "torch")
        #: captured groups by (signature, k) and their replays so far
        self._graphs: Dict[Any, _Graph] = {}
        self.graph_replays = 0
        #: the model's ``graph_version`` the captured groups read
        self._graphs_version = None
        #: batches of the current (or last) epoch run inside a replay
        self.replayed_batches = 0
        self._capture: Optional[bool] = None  # decided at the first group
        self._capture_stream = None
        self._lr_buffer: Optional[torch.Tensor] = None
        self._resident: Optional[Dict[str, torch.Tensor]] = None
        self._prepare_time = 0.0
        if model is None:
            model = KgeModel.create(config, dataset, device=self.device,
                                    generator=self.generator)
        self.model = model
        self.model.normalize_params()
        self.loss = KgeLoss.create(config)
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
            sparse_paths=self._sparse_paths,
            sharded=self.model.sharded_tables())
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
            valid_conf.log_folder = config.log_folder
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

    def _seed_generators(self, epoch: int):
        """Reseed the generators of the device's draws and of dropout's
        masks for ``epoch`` from ``random_seed.torch`` (outside any
        capture: a CUDA generator cannot be reseeded while a graph is
        captured), so a resumed run draws the uninterrupted run's from
        epoch k on; an unseeded job keeps one stream of each."""
        if self._torch_seed >= 0:
            self._sampling_gen.manual_seed(
                derived_seed(self._torch_seed, epoch, "sampling"))
            self._dropout_gen.manual_seed(
                derived_seed(self._torch_seed, epoch, "dropout"))

    def _expand_device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Strategy hook: the batch's content made on the device from a
        small payload (on-device negative sampling), at the start of its
        step, so every subbatch sees one draw. Default: the payload is
        the batch."""
        return batch

    def _epoch_device_payload(self, epoch: int
                              ) -> Optional[Dict[str, np.ndarray]]:
        """Strategy hook: the whole epoch as one stacked host payload
        ``{key: [M, ...]}`` (M batches), uploaded once for device-resident
        grouped dispatch, or None where each batch is collated on the
        host."""
        return None

    def _stack_group_batches(self, buffered: List[Dict[str, np.ndarray]]
                             ) -> Dict[str, np.ndarray]:
        """k host batches of one structure stacked on a leading k axis."""
        return {key: np.stack([b[key] for b in buffered])
                for key in buffered[0]}

    def _capture_unsupported_reasons(self) -> List[str]:
        """Why this job's groups of steps cannot be captured into CUDA
        graphs as they stand (empty when they can). A graph replays fixed
        device work on fixed buffers, so a step must not depend on the
        host between steps: no tensor rebound between steps, no
        collective outside the graph, no host payload of another shape.
        Dropout (its generator registered with the graph), the model
        state (updated in place), row-sparse steps (their row payload in
        the graph's buffers, the learning rate read on the device) and
        R-GNN encoders on a fixed graph (no layer reads the host inside
        a step; a rebuilt graph drops the captured groups) are captured.
        Eager stay: steps under a device mesh (their collectives) and,
        in negative sampling, graph sampling (a new graph every
        epoch)."""
        reasons = []
        if self.mesh is not None:
            reasons.append("steps under a device mesh run their collectives "
                           "eagerly (collectives are not captured into "
                           "CUDA graphs yet)")
        return reasons

    def _captures(self) -> bool:
        """Whether groups of steps run as CUDA graphs: on a card, when
        ``_capture_unsupported_reasons`` finds nothing (decided once,
        logged)."""
        if self._capture is None:
            self._capture = self.device.type == "cuda"
            if self._capture:
                reasons = self._capture_unsupported_reasons()
                if reasons:
                    self._capture = False
                    self.config.log(
                        "Running grouped steps eagerly, not as CUDA graphs: "
                        + "; ".join(reasons))
                else:
                    self.config.log(
                        "Capturing groups of "
                        f"{self._steps_per_dispatch()} steps as CUDA graphs.")
        return self._capture

    def _part_context(self, ctx: Ctx,
                      shard: Optional[BatchShard] = None) -> Ctx:
        """A fresh training Ctx for one part of a step: the step's state
        and tables, the dropout generator, no updates yet; under a mesh,
        the rows of the part this rank computes."""
        return Ctx(train=True, generator=self._dropout_gen,
                   state=ctx.state, tables=ctx.tables, shard=shard)

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

    def _parts(self) -> List[Tuple[slice, Optional[BatchShard]]]:
        """The parts of a step (its subbatches) as the rows this rank
        computes: each whole off a mesh; under a mesh, the rank's block
        of the part's rows over the data axis and its ``BatchShard``."""
        size = self.batch_size
        sub = self.subbatch_size if self.subbatch_size > 0 else size
        parts = [(i, min(i + sub, size)) for i in range(0, size, sub)]
        if self.mesh is None:
            return [(slice(a, b), None) for a, b in parts]
        data, index = self.mesh.shape["data"], self.mesh.data_index
        group = self.mesh.group("data") if data > 1 else None
        out = []
        for a, b in parts:
            n = b - a
            lo, hi = n * index // data, n * (index + 1) // data
            out.append((slice(a + lo, a + hi), BatchShard(lo, hi, n, group)))
        return out

    def _data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def _reduce_gradients(self, grads: List[torch.Tensor]):
        """Sum ``grads`` over the data group in place (one collective)."""
        if self._data_size() == 1 or not grads:
            return
        with record_function("train.reduce_gradients"):
            flat = dist.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                   self.mesh.group("data"))
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _average_over_model(self, grads: List[torch.Tensor]):
        """Under a model axis above 1, ``grads`` (the replicated
        parameters') replaced in place by their mean over the model group
        (one collective): a no-op in exact arithmetic, and on a card it
        undoes the atomics' last bits (an R-GNN encoder's ``index_add_``),
        so the ranks' copies never drift apart."""
        if self.mesh is None or self.mesh.shape["model"] == 1 or not grads:
            return
        with record_function("train.reduce_gradients"):
            flat = dist.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                   self.mesh.group("model"))
            flat /= self.mesh.shape["model"]
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _step(self, batch: Dict[str, Any], lrs: Dict[str, Any],
              correction: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """One train step on an uploaded batch; returns its metrics as
        0-d device tensors (no host sync).
        ``lrs``: each group's learning rate (a float or a 0-d device
        tensor); ``correction``: this step's Adam bias corrections on the
        device (``KgeOptimizer.advance``; by default the optimizer
        advances its counts itself)."""
        with record_function("train.forward"):
            batch = self._expand_device_batch(batch)
        parts = self._parts()
        if self.is_forward_only:
            ctx, _ = self._step_context(batch)
            with torch.no_grad(), record_function("train.forward"):
                total = sum(
                    self._subbatch_loss(
                        self._part_context(ctx, shard), batch, sl)
                    for sl, shard in parts)
            return {"avg_loss": total, "avg_penalty": torch.zeros_like(total),
                    "avg_cost": total}

        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        with record_function("train.forward"):
            ctx, rows = self._step_context(batch)
        total_loss = 0.0
        updates: Dict[str, Any] = {}
        for sl, shard in parts:
            with record_function("train.forward"):
                part = self._part_context(ctx, shard)
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
                self._part_context(ctx),
                batch=self._penalty_batch(batch)
            )
            # every rank computes the whole penalty: each counts for its
            # share, so the sum over the data group counts it once
            data = self._data_size()
            terms = [(k, v / data if data > 1 else v) for k, v in terms]
            penalty_total = torch.zeros((), device=self.device)
            for _, v in terms:
                penalty_total = penalty_total + v
        if terms:
            with record_function("train.backward"):
                penalty_total.backward()
            penalty_total = penalty_total.detach()
        sharded = self.model.sharded_tables()
        self._average_over_model(
            [p.grad for name, p in self.model.named_parameters()
             if p.grad is not None and name not in sharded])
        self._reduce_gradients(
            [p.grad for p in params if p.grad is not None]
            + [gathered.grad for _, gathered in rows.values()])
        with record_function("train.optimizer"):
            self.optimizer.step(self.opt_state, lrs, correction)
            # every sparse table of the step in one call: one launch of
            # the row-update kernel on a card
            if rows:
                self.optimizer.sparse_row_update(
                    self.opt_state, self._owned_rows(rows), lrs)
            self.model.normalize_params()
            # in place: a captured graph and the evaluation read them there
            copy_state(self.model.model_state, updates)
        return {
            "avg_loss": total_loss,
            "avg_penalty": penalty_total,
            "avg_cost": total_loss + penalty_total,
            **{f"avg_penalty_{k}": v.detach() for k, v in terms},
        }

    def _owned_rows(self, rows) -> Dict[str, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
        """``{table name: (uniq, row gradients)}`` of a row-sparse step,
        under a mesh the rows this rank's block owns, as its local
        ids."""
        sharded = self.model.sharded_tables()
        out = {}
        for name, (uniq, gathered) in rows.items():
            grad, module = gathered.grad, sharded.get(name)
            if module is not None:
                lo, n = module.row_lo, module.weights.shape[0]
                owned = (uniq >= lo) & (uniq < lo + n)
                uniq, grad = uniq[owned] - lo, grad[owned]
            out[name] = (uniq, grad)
        return out

    def _group_steps(self, k: int, lrs: Dict[str, Any],
                     resident: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Callable:
        """The k steps of one group as ``run(inputs)``: step i reads
        its batch from ``inputs`` (host batches stacked on a leading k
        axis) or, with a ``resident`` epoch payload, from its row
        ``inputs["_start"] + i``, and its Adam bias corrections from
        ``inputs["_corrections"][i]``; returns the metric names and their
        values [k, n]. The math is k per-batch steps'."""
        def run(inputs: Dict[str, torch.Tensor]):
            corrections = inputs.get("_corrections")
            names, rows = [], []
            for i in range(k):
                if resident is None:
                    batch = {key: v[i] for key, v in inputs.items()
                             if not key.startswith("_")}
                else:
                    at = inputs["_start"] + i
                    batch = {key: v.index_select(0, at).squeeze(0)
                             for key, v in resident.items()}
                metrics = self._step(
                    batch, lrs,
                    None if corrections is None else corrections[i])
                names = list(metrics)
                rows.append(torch.stack([metrics[n] for n in names]))
            return names, torch.stack(rows)
        return run

    def _dispatch_group(self, key, host: Dict[str, np.ndarray],
                        run: Callable) -> Tuple[List[str], torch.Tensor]:
        """One group of steps: eagerly (on the CPU, or where
        ``_captures`` says no), else by replaying its captured graph (the
        first group of each key runs eagerly as the capture's warm-up).
        ``host``: the group's inputs as host arrays."""
        if not self._captures():
            return run(self._put_batch(host))
        version = getattr(self.model, "graph_version", None)
        if version != self._graphs_version:
            # a rebuilt encoder graph: the captured groups read the old one
            self._graphs = {}
            self._graphs_version = version
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture_group(key, host, run)
        t0 = time.time()
        with record_function("train.upload"):
            for name, buffer in entry.inputs.items():
                to_device(self._host_array(host[name]), self.device,
                          out=buffer)
        self._prepare_time += time.time() - t0
        with record_function("train.replay"):
            entry.graph.replay()
        for wrapper, n in entry.launches:
            wrapper.launches += n
        self.graph_replays += 1
        self.replayed_batches += entry.out.shape[0]
        return entry.names, entry.out.clone()

    def _capture_group(self, key, host: Dict[str, np.ndarray],
                       run: Callable) -> Tuple[List[str], torch.Tensor]:
        """Run this group eagerly on the capture stream (the warm-up, as
        PyTorch's whole-network capture wants: autograd's lazy state, the
        cuBLAS workspace of that stream, each kernel's attributes), then
        capture ``run`` on buffers of its inputs into a graph for the
        next groups of ``key``. Capture launches nothing, so the launches
        the wrappers counted while it ran come off again."""
        inputs = self._put_batch(host)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream, current = self._capture_stream, torch.cuda.current_stream(
            self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            names, out = run(inputs)
            buffers = {name: t.clone() for name, t in inputs.items()}
        current.wait_stream(stream)
        out.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._sampling_gen)
        graph.register_generator_state(self._dropout_gen)
        before = [w.launches for w in COUNTED_KERNELS]
        with torch.cuda.graph(graph, stream=stream):
            _, captured = run(buffers)
        launches = []
        for wrapper, n in zip(COUNTED_KERNELS, before):
            if wrapper.launches != n:
                launches.append((wrapper, wrapper.launches - n))
                wrapper.launches = n
        self._graphs[key] = _Graph(graph, buffers, names, captured, launches)
        return names, out

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
        if not self.config.folder or not dist.is_primary():
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
        """One epoch; with ``tpu.profile_dir``, epoch 1 under
        ``torch.profiler`` (host and device), its Chrome trace written
        into that folder."""
        profile_dir = self.config.get("tpu.profile_dir")
        if not (profile_dir and self.epoch == 1):
            return self._run_epoch_inner()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as profiler:
            result = self._run_epoch_inner()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(profile_dir, f"epoch_{self.epoch}.trace.json"))
        self.config.log(f"Wrote device trace to {profile_dir}")
        return result

    def _epoch_lrs(self) -> Dict[str, Any]:
        """Each group's learning rate for this epoch: 0-d views of one
        float32 device buffer, filled here, which captured steps read
        (the dense update and the row-update kernel alike)."""
        scale = self.lr_scheduler.lr_scale(self.epoch)
        lrs = {g: base * scale for g, base in self.optimizer.base_lrs.items()}
        if self._lr_buffer is None:
            self._lr_buffer = torch.empty(len(lrs), dtype=torch.float32,
                                          device=self.device)
        self._lr_buffer.copy_(torch.tensor(list(lrs.values()),
                                           dtype=torch.float32))
        return {g: self._lr_buffer[i] for i, g in enumerate(lrs)}

    def _group_corrections(self, host: Dict[str, np.ndarray], k: int):
        """Advance the optimizer's step counts by a group's k steps and
        add their bias corrections to the group's inputs (Adam family)."""
        if not self.is_forward_only:
            corrections = self.optimizer.advance(self.opt_state, k)
            if corrections is not None:
                host["_corrections"] = corrections

    def _run_epoch_inner(self) -> Dict[str, Any]:
        """``kge_tpu``'s ``_run_epoch_inner``: the batches in groups of
        ``_steps_per_dispatch`` (only batches of one structure stack),
        each group one dispatch, a shorter run of batches dispatched per
        batch; or the device-resident epoch, uploaded once."""
        for f in self.pre_epoch_hooks:
            f(self)
        lrs = self._epoch_lrs()
        self._seed_generators(self.epoch)
        epoch_start = time.time()
        self._prepare_time = 0.0
        self.replayed_batches = 0
        batch_metrics: List[Tuple[np.ndarray, List[str], list]] = []
        num_batches = 0
        group_size = self._steps_per_dispatch()

        def flush(buffered, sig):
            """A full group as one dispatch, else batch by batch."""
            k = len(buffered)
            sizes = np.asarray([float(b["size"]) for b in buffered])
            if k == group_size and group_size > 1:
                t0 = time.time()
                with record_function("train.upload"):
                    host = self._stack_group_batches(buffered)
                    self._group_corrections(host, k)
                self._prepare_time += time.time() - t0
                names, values = self._dispatch_group(
                    (sig, k), host, self._group_steps(k, lrs))
                batch_metrics.append((sizes, names, [values]))
                return
            for i, batch_np in enumerate(buffered):
                t0 = time.time()
                with record_function("train.upload"):
                    batch = self._put_batch(batch_np)
                self._prepare_time += time.time() - t0
                metrics = self._step(batch, lrs)
                names = list(metrics)
                batch_metrics.append(
                    (sizes[i:i + 1], names, [metrics[n] for n in names]))

        def signature(batch_np):
            return tuple((key, np.shape(v), str(np.asarray(v).dtype))
                         for key, v in sorted(batch_np.items()))

        resident_np = (
            self._epoch_device_payload(self.epoch)
            if group_size > 1
            # batch hooks expect per-batch cadence on the host
            and not self.pre_batch_hooks and not self.post_batch_hooks
            else None
        )
        if resident_np is not None:
            # the whole (small) epoch goes up once; each group then
            # ships its start index
            M = int(np.shape(resident_np["size"])[0])
            k = min(group_size, M)
            t0 = time.time()
            with record_function("train.upload"):
                run = self._group_steps(
                    k, lrs, resident=self._resident_payload(resident_np))
            self._prepare_time += time.time() - t0
            full = (M // k) * k
            for d in range(0, full, k):
                host = {"_start": np.asarray([d], dtype=np.int64)}
                self._group_corrections(host, k)
                names, values = self._dispatch_group(
                    ("epoch", k), host, run)
                batch_metrics.append((
                    np.asarray(resident_np["size"][d:d + k],
                               dtype=np.float64), names, [values]))
            num_batches = M
            if full < M:  # a tail shorter than k: per-batch steps
                flush([{key: v[j] for key, v in resident_np.items()}
                       for j in range(full, M)], None)
            return self._finish_epoch(batch_metrics, num_batches,
                                      epoch_start)

        depth = int(self.config.get("tpu.prefetch_batches"))
        if depth < 0:
            # auto: the reference's DataLoader-worker intent
            depth = min(2 * int(self.config.get("train.num_workers")), 8)
        buffered: List[Dict[str, np.ndarray]] = []
        buffered_sig = None
        with contextlib.closing(
                _prefetch(self._generate_batches(self.epoch), depth)
        ) as batches:
            while True:
                with record_function("train.collate"):
                    batch_np = next(batches, None)
                if batch_np is None:
                    break
                for f in self.pre_batch_hooks:
                    f(self)
                # only batches of one structure stack into one group
                # (KvsAll interleaves query types and label widths)
                sig = signature(batch_np) if group_size > 1 else None
                if buffered and sig != buffered_sig:
                    flush(buffered, buffered_sig)
                    buffered = []
                buffered.append(batch_np)
                buffered_sig = sig
                num_batches += 1
                if len(buffered) == group_size:
                    flush(buffered, sig)
                    buffered = []
                for f in self.post_batch_hooks:
                    f(self)
        if buffered:
            flush(buffered, buffered_sig)
        return self._finish_epoch(batch_metrics, num_batches, epoch_start)

    def _resident_payload(self, resident_np: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
        """The epoch payload on the device, in buffers kept from epoch to
        epoch (a captured graph reads them where they are); new buffers,
        and no captured group, when its shapes change."""
        arrays = {k: self._host_array(v) for k, v in resident_np.items()}
        if self._resident is None or any(
                tuple(self._resident[k].shape) != v.shape
                for k, v in arrays.items()):
            self._resident = self._put_batch(arrays)
            self._graphs = {}
            return self._resident
        for key, buffer in self._resident.items():
            to_device(arrays[key], self.device, out=buffer)
        return self._resident

    def _finish_epoch(self, batch_metrics, num_batches: int,
                      epoch_start: float) -> Dict[str, Any]:
        """Fetch the epoch's metrics (one transfer), aggregate, trace.
        ``batch_metrics``: per dispatch, the batches' true sizes, the
        metric names and their device values (0-d each, or one [k, n])."""
        with record_function("train.fetch"):
            flat = [t.reshape(-1) for _, _, values in batch_metrics
                    for t in values]
            flat = torch.cat(flat) if flat else torch.zeros(
                0, device=self.device)
            if self._data_size() > 1:
                # each rank's losses are its rows' share of the global
                # batch's (its penalties a 1/data share): the sum is the
                # global batch's
                dist.all_reduce(flat, self.mesh.group("data"))
            fetched = flat.cpu().double().numpy()
        per_batch = []
        position = 0
        for sizes, names, _ in batch_metrics:
            for size in sizes:
                row = fetched[position:position + len(names)]
                per_batch.append((float(size), dict(
                    zip(names, (float(v) for v in row)))))
                position += len(names)
        # avg_* epoch metrics are example-weighted batch averages:
        # sum(batch_avg * true_batch_size) / num_examples, so a short tail
        # batch does not skew the epoch average
        sums: Dict[str, float] = {}
        total_size = 0.0
        for size, metrics in per_batch:
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
            prepare_time=self._prepare_time,
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
        if self._capture:
            # beside the trace entry, whose keys are kge_tpu's
            self.config.log(f"Epoch {self.epoch}: {self.replayed_batches} "
                            f"of {num_batches} batches replayed as CUDA "
                            "graphs.")
        if self.config.get("train.trace_level") == "batch":
            # one entry per real batch, grouped dispatches included
            for batch_index, (_, metrics) in enumerate(per_batch):
                self.trace(type=self.type_str, scope="batch",
                           epoch=self.epoch, batch=batch_index, **metrics)
        return trace_entry

    # ------------------------------------------------------------------ checkpoints

    def _save(self, filename: str):
        """Write a checkpoint of whole tables: under a mesh every rank
        gathers the shards (collective), rank 0 alone writes, and all
        meet at a barrier after the write."""
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
        if not dist.is_primary():
            dist.barrier()
            return
        self.config.save_to(checkpoint)
        self.dataset.save_to(checkpoint)
        try:
            save_checkpoint(filename, checkpoint)
        finally:
            # the other ranks wait here, whether the write failed or not
            dist.barrier()

    def _load(self, checkpoint: Dict[str, Any]):
        if checkpoint["type"] != "train":
            raise ValueError("training can only be continued from trained models")
        self.model.load_params(checkpoint["model"]["params"])
        # into the state's tensors, where a captured graph reads them
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

    @staticmethod
    def _host_array(value) -> np.ndarray:
        """A batch value as the host array of its device tensor: integer
        arrays as int64 (index tensors)."""
        array = np.asarray(value)
        if array.dtype.kind in "iu":
            array = array.astype(np.int64)
        return array

    def _put_batch(self, batch_np: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """Host batch -> device. Arrays go up through pinned memory without
        waiting for queued work (integer arrays as int64 index tensors);
        scalars (the true size, the number of unique negatives) become
        0-d device tensors, so a step reads no value on the host."""
        return {key: to_device(self._host_array(value), self.device)
                for key, value in batch_np.items()}

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
