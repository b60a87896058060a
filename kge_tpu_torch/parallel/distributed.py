"""Process bootstrap, host-level agreement and global fetches over
``torch.distributed`` (counterpart of ``kge_tpu/parallel/distributed.py``).

One process drives one device. ``maybe_init_from_config`` (called by the
CLI and by every training job before any other collective) starts the
process group from ``tpu.multihost``: ``coordinator_address`` is the
``tcp://`` rendezvous, ``num_processes`` the world size, ``process_id``
the rank, each falling back to ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` as in ``kge_tpu``, or to a
launcher's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
(``torchrun``'s). The group has a timeout, so a lost rank fails the
others instead of hanging them.

The backend: ``gloo`` on the host; on the card ``nccl`` where every
rank of a node has a card of its own (with gloo beside it for host
tensors: seeds, flags), and ``gloo`` where ranks share a card (NCCL
refuses two ranks on one GPU). gloo takes CUDA tensors in
``all_reduce``, ``all_gather``, ``broadcast`` and ``reduce_scatter``
(it copies them to the host itself) and refuses them in ``all_to_all``:
there ``all_to_all`` (the R-GNN halo exchange) stages them through
pinned host memory (``all_to_all_route``, logged by the encoder that
uses it); NCCL takes them as they are.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
from torch.profiler import record_function

from kge_tpu_torch.config import Config

#: a lost rank fails the collective that waits on it after this long
TIMEOUT = datetime.timedelta(seconds=600)

_BACKEND_REASON = ""


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def local_process_count() -> int:
    """The ranks of this node (``LOCAL_WORLD_SIZE``; the whole world
    without a launcher that sets it)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return process_count()


def local_rank() -> int:
    """This rank's index on its node (``LOCAL_RANK``; the global rank
    without a launcher that sets it)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index()


def choose_backend(device_type: str) -> tuple:
    """(backend, reason): gloo on the host; on the card nccl where the
    node's ranks each have a card, else gloo."""
    if device_type != "cuda":
        return "gloo", "the job runs on the host"
    cards = torch.cuda.device_count()
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    if ranks > cards:
        return "gloo", (f"{ranks} ranks share {cards} card(s) on this node "
                        "and NCCL refuses two ranks on one GPU")
    return "nccl", f"each of the node's {ranks} ranks has a card of its own"


def backend() -> str:
    return _dist().get_backend() if is_initialized() else ""


def backend_reason() -> str:
    return _BACKEND_REASON


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cpu", strict: bool = False):
    """Start the process group from the arguments, ``kge_tpu``'s
    environment variables or a launcher's. Idempotent. Without any of
    them there is nothing to join: ``strict`` (``tpu.multihost.enabled:
    on``) raises then instead of running as one process."""
    global _BACKEND_REASON
    if is_initialized():
        return
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        for key in ("JAX_NUM_PROCESSES", "WORLD_SIZE"):
            if key in env:
                num_processes = int(env[key])
                break
    if process_id is None:
        for key in ("JAX_PROCESS_ID", "RANK"):
            if key in env:
                process_id = int(env[key])
                break
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None or num_processes is None:
        if strict:
            raise RuntimeError(
                "tpu.multihost.enabled is on but no rendezvous is "
                "configured: set tpu.multihost.coordinator_address and "
                "num_processes, or MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK"
            )
        return
    if process_id is None:
        if num_processes > 1:
            # a silent 0 default would register every process as rank 0
            raise ValueError(
                "multi-host run needs a distinct process id per host: set "
                "tpu.multihost.process_id, JAX_PROCESS_ID or RANK"
            )
        process_id = 0
    name, _BACKEND_REASON = choose_backend(device_type)
    if name == "nccl":
        # host tensors (seeds, flags) keep a gloo path beside NCCL
        name = "cpu:gloo,cuda:nccl"
    _dist().init_process_group(
        name, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def maybe_init_from_config(config: Config):
    """Start the process group per the ``tpu.multihost`` section:
    ``off`` never; ``on`` from the config keys (the environment fills
    unset ones), raising without a rendezvous; ``auto`` only on an
    explicit signal (a configured or environment coordinator or process
    count, or a launcher's ``WORLD_SIZE``), so a plain run never starts
    one. The card or the host, by ``job.device``."""
    mode = str(config.get("tpu.multihost.enabled")).lower()
    if mode in ("off", "false", "0"):
        return
    addr = config.get("tpu.multihost.coordinator_address") or None
    nproc = int(config.get("tpu.multihost.num_processes"))
    pid = int(config.get("tpu.multihost.process_id"))
    device_type = "cpu" if config.get("job.device") == "cpu" else "cuda"
    signal = addr or nproc > 0 or any(
        key in os.environ for key in
        ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "WORLD_SIZE"))
    if mode in ("on", "true", "1") or signal:
        init_distributed(addr, nproc if nproc > 0 else None,
                         pid if pid >= 0 else None, device_type,
                         strict=mode in ("on", "true", "1"))


def use_rank_log_folder(config: Config):
    """A rank other than 0 logs and traces into ``<folder>/proc<i>/``,
    out of the shared ``kge.log`` and ``trace.yaml``."""
    if config.folder and not is_primary():
        config.log_folder = os.path.join(config.folder,
                                         f"proc{process_index()}")
        os.makedirs(config.log_folder, exist_ok=True)


def is_primary() -> bool:
    """True on the process that owns the side effects on the shared
    folder (checkpoints); always True single-process."""
    return process_index() == 0


def broadcast_int(value: int) -> int:
    """Rank 0's value on every rank (an unseeded run's seeds must agree:
    every rank draws the global batch). No-op single-process."""
    if process_count() <= 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    _dist().broadcast(t, src=0)
    return int(t.item())


def all_flags(value: int) -> List[int]:
    """Every rank's ``value`` (a small int), in rank order."""
    if process_count() <= 1:
        return [int(value)]
    out = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count())]
    _dist().all_gather(out, torch.tensor([int(value)], dtype=torch.int64))
    return [int(t.item()) for t in out]


def barrier(name: str = ""):
    """A sync point after rank 0's writes to the shared folder (no-op
    single-process)."""
    if process_count() > 1:
        _dist().barrier()


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place (a ``comm.all_reduce``
    span: a profile reads the collectives' share of a step from the
    ``comm.*`` spans)."""
    with record_function("comm.all_reduce"):
        _dist().all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank of ``group``'s ``tensor`` (one shape on every rank),
    in group-rank order (a ``comm.all_gather`` span)."""
    dist = _dist()
    src = tensor.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    with record_function("comm.all_gather"):
        dist.all_gather(parts, src, group=group)
    return parts


def all_to_all_route(device_type: str) -> Tuple[bool, str]:
    """(staged, reason): whether ``all_to_all`` of a tensor on
    ``device_type`` goes through pinned host memory (gloo refuses CUDA
    tensors there; NCCL takes them, gloo takes host tensors)."""
    name = backend()
    if device_type != "cuda":
        return False, f"host tensors, {name or 'no'} backend"
    if "nccl" in name:
        return False, "CUDA tensors through NCCL"
    return True, (f"CUDA tensors staged through pinned host memory ({name} "
                  "refuses CUDA tensors in all_to_all)")


def all_to_all(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Row block q of ``tensor`` (equal blocks, one a rank of ``group``)
    sent to rank q; block q of the result came from rank q (a
    ``comm.all_to_all`` span; staged per ``all_to_all_route``)."""
    src = tensor.contiguous()
    staged, _ = all_to_all_route(src.device.type)
    with record_function("comm.all_to_all"):
        if not staged:
            out = torch.empty_like(src)
            _dist().all_to_all_single(out, src, group=group)
            return out
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        received = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        _dist().all_to_all_single(received, host, group=group)
        return received.to(src.device, non_blocking=True)


def put_global(array, mesh, sharded: bool):
    """This rank's part of a host array (or tensor) every rank holds
    whole: its row block over ``model`` for a sharded table, else all of
    it."""
    if not sharded or mesh is None or mesh.shape["model"] == 1:
        return array
    lo, hi = mesh.rows(int(array.shape[0]))
    return array[lo:hi]


def fetch_global(tensor: torch.Tensor, mesh, sharded: bool) -> torch.Tensor:
    """The whole of a leaf: the row blocks of a sharded table gathered
    over ``model`` (collective: every rank of the group calls it at the
    same point); a replicated leaf as it is."""
    if not sharded or mesh is None or mesh.shape["model"] == 1:
        return tensor
    return torch.cat(all_gather(tensor, mesh.group("model")), dim=0)
