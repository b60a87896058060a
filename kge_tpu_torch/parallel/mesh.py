"""The (data, model) device mesh over processes (counterpart of
``kge_tpu/parallel/mesh.py``).

A JAX process drives several devices; a torch process drives one. So a
mesh device is a process (a rank): ``data x model`` equals the world
size, and rank ``r`` sits at ``(r // model, r % model)``, rank-major.
That is the process-major device order of ``kge_tpu``'s
``build_hybrid_mesh``, so a ``model`` tile stays inside one node. Each
rank holds two process groups:

- ``data``: the ranks with its model index. Batches shard over it, and
  gradients and partial losses are summed over it;
- ``model``: the ranks with its data index. Every 2-D ``weights`` leaf
  (an embedding table) is stored as this rank's block of rows over it,
  and lookups, table gathers and rank counts reduce over it.

``active()`` is the mesh of the running training job (set by the job,
read by the embedders when they lay out their tables); ``None`` outside
a mesh job, where every table is whole.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from kge_tpu_torch.config import Config


def layout(data: int, model: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The rank lists of the mesh's groups: the ``data`` groups (one per
    model index: the ranks of one column) and the ``model`` groups (one
    per data index: the ranks of one row)."""
    data_groups = [[d * model + m for d in range(data)]
                   for m in range(model)]
    model_groups = [[d * model + m for m in range(model)]
                    for d in range(data)]
    return data_groups, model_groups


class Mesh:
    """One rank's view of the mesh: ``shape`` ``{"data": D, "model":
    M}``, its coordinates, its two groups' ranks and, under a process
    group, the groups themselves (``None`` for the rank lists alone, as
    in ``mesh_shape``'s checks)."""

    def __init__(self, data: int, model: int, rank: int,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        data_groups, model_groups = layout(data, model)
        self.data_ranks = data_groups[self.model_index]
        self.model_ranks = model_groups[self.data_index]
        self.groups = groups or {}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def group(self, axis: str):
        """The process group of ``axis`` (``data`` or ``model``)."""
        return self.groups[axis]

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's block ``[lo, hi)`` of ``n`` rows sharded over
        ``model`` (``n`` divides by it: tables are padded to
        lcm(8, model))."""
        return _block(n, self.shape["model"], self.model_index)

    def batch_rows(self, n: int) -> Tuple[int, int]:
        """This rank's block ``[lo, hi)`` of a batch axis of ``n`` rows
        sharded over ``data`` (``n`` divides by it)."""
        return _block(n, self.shape["data"], self.data_index)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords=({self.data_index}, {self.model_index}))")


def _block(n: int, parts: int, index: int) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{n} rows do not divide into {parts} shards")
    size = n // parts
    return index * size, (index + 1) * size


def mesh_shape(config: Config, world_size: int,
               local_world_size: Optional[int] = None
               ) -> Optional[Tuple[int, int]]:
    """``(data, model)`` of the configured mesh over ``world_size``
    processes, or None for a 1x1 mesh; ``data: -1`` fills the world.
    Raises ``kge_tpu``'s errors: a mesh larger than the world, and for
    several processes ``build_hybrid_mesh``'s three (``model`` past the
    ranks of one node, ``model`` not dividing them, a mesh that leaves
    ranks out). ``local_world_size``: the ranks of one node."""
    data = config.get("tpu.mesh.data")
    model = config.get("tpu.mesh.model")
    if data == -1:
        data = max(1, world_size // max(model, 1))
    if data * model == 1:
        return None
    if world_size > 1:
        per_node = local_world_size or world_size
        if model > per_node:
            raise ValueError(
                f"model axis {model} exceeds per-host device count "
                f"{per_node}; model sharding must stay on ICI"
            )
        if per_node % model != 0:
            raise ValueError(
                f"model axis {model} must divide the per-host device "
                f"count {per_node}"
            )
        if data * model != world_size:
            raise ValueError(
                f"multi-host meshes must use every device so all "
                f"processes participate: {data}x{model} != {world_size} "
                "devices"
            )
    elif data * model > world_size:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have "
            f"{world_size} (start one process per device: see "
            "tpu.multihost)"
        )
    return data, model


_ACTIVE: Optional[Mesh] = None
_GROUPS: Dict[Tuple[int, int], Dict[str, object]] = {}


def build_mesh(config: Config) -> Optional[Mesh]:
    """The configured mesh of this process group (None for 1x1 or
    without a process group and a 1x1 mesh). Every rank creates every
    group, in one order, once per mesh shape."""
    from kge_tpu_torch.parallel import distributed as dist

    world = dist.process_count()
    shape = mesh_shape(config, world, dist.local_process_count())
    if shape is None:
        return None
    data, model = shape
    groups = _GROUPS.get(shape)
    if groups is None:
        import torch.distributed as tdist

        data_groups, model_groups = layout(data, model)
        rank = dist.process_index()
        groups = {}
        for axis, lists in (("data", data_groups), ("model", model_groups)):
            for ranks in lists:
                group = tdist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
        _GROUPS[shape] = groups
    return Mesh(data, model, dist.process_index(), groups)


def active() -> Optional[Mesh]:
    """The mesh of the running training job, or None."""
    return _ACTIVE


def set_active(mesh: Optional[Mesh]):
    global _ACTIVE
    _ACTIVE = mesh


def params_sharding(named_params: Iterable[Tuple[str, object]]
                    ) -> Dict[str, bool]:
    """``kge_tpu``'s rule, by parameter name: every 2-D leaf named
    ``weights`` (an embedding table) shards its rows over ``model``
    (True); everything else is replicated (False)."""
    return {name: name.split(".")[-1] == "weights" and p.dim() == 2
            for name, p in named_params}


def batch_sharding(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a global batch (a multiple of the data
    axis) this rank computes."""
    return mesh.batch_rows(batch_size)
