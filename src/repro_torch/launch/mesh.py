"""Mesh plans: the port of ``repro/launch/mesh.py``.

A mesh here is a ``MeshPlan``: an ordered dict of axis name -> size, all
that the sharding rules read (the reference's rules read only
``mesh.shape``).  Building one touches no device; ``device_mesh(plan,
device)`` turns it into a ``torch.distributed`` ``DeviceMesh`` over the
process group's ranks when there is one to run on.

Mesh axes (outer -> inner):
  pod   : across pods (slow links).  Present when multi_pod.
  part  : traffic-shaping partitions within a pod (the paper's knob).
          Present when partitions > 1.
  data  : synchronous data parallel + FSDP weight storage within a
          partition.
  model : tensor / expert parallel (the fast links).

The reference's production shapes (16 x 16 a pod, two pods) are kept as
they are, so a plan and every spec the rules derive from it equal the
reference's.  The reference's ``mesh_context`` (an ambient JAX mesh) has
no counterpart: a DTensor takes its mesh explicitly, and
``models.pspec.axes`` carries it for the activation pins.
"""
from __future__ import annotations

from dataclasses import dataclass

POD_CHIPS = 256          # 16 x 16 a pod slice
DATA_AXIS = 16
MODEL_AXIS = 16
N_PODS = 2


@dataclass(frozen=True)
class MeshPlan:
    """Axis names and sizes, outer to inner: ``shape`` is a dict in that
    order, as ``jax.sharding.Mesh.shape`` is."""
    names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.names) != len(self.sizes) or \
                len(set(self.names)) != len(self.names):
            raise ValueError(f"mesh plan: names {self.names} and sizes "
                             f"{self.sizes} do not pair up")

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def _mk(shape, axes) -> MeshPlan:
    return MeshPlan(tuple(axes), tuple(int(s) for s in shape))


def plan_of(mesh) -> MeshPlan:
    """The plan of ``mesh``: a ``MeshPlan`` itself, or a ``DeviceMesh``'s
    names and sizes."""
    if isinstance(mesh, MeshPlan):
        return mesh
    return MeshPlan(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_production_mesh(*, multi_pod: bool = False, partitions: int = 1):
    """(16,16) data x model single-pod; (2,16,16) pod x data x model multi-pod.

    ``partitions`` > 1 factors the data axis into (part, data//part): cores
    in a partition stay synchronous, partitions run asynchronously (paper
    §3).
    """
    if partitions == 1:
        if multi_pod:
            return _mk((N_PODS, DATA_AXIS, MODEL_AXIS),
                       ("pod", "data", "model"))
        return _mk((DATA_AXIS, MODEL_AXIS), ("data", "model"))
    if DATA_AXIS % partitions:
        raise ValueError(f"partitions={partitions} must divide {DATA_AXIS}")
    inner = DATA_AXIS // partitions
    if multi_pod:
        return _mk((N_PODS, partitions, inner, MODEL_AXIS),
                   ("pod", "part", "data", "model"))
    return _mk((partitions, inner, MODEL_AXIS), ("part", "data", "model"))


def make_partition_submesh(partitions: int):
    """The mesh a SINGLE partition group runs on between syncs: the paper's
    per-partition synchronous group."""
    if DATA_AXIS % partitions:
        raise ValueError(f"partitions={partitions} must divide {DATA_AXIS}")
    return _mk((DATA_AXIS // partitions, MODEL_AXIS), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1):
    """Small mesh over the locally available devices (tests / examples)."""
    return _mk((data, model), ("data", "model"))


def device_mesh(plan: MeshPlan, device: str = "cuda"):
    """The ``DeviceMesh`` of ``plan`` over the ranks of the initialised
    ``torch.distributed`` process group (``device``: "cuda" or "cpu", its
    device type), axis names kept.  Raises when the group's world size is
    not the plan's product."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh: torch.distributed is not "
                           "initialised (init_process_group first)")
    world = dist.get_world_size()
    if world != plan.size:
        raise ValueError(f"device_mesh: the process group has {world} "
                         f"ranks, the plan {plan.shape} needs {plan.size}")
    return init_device_mesh(device, plan.sizes, mesh_dim_names=plan.names)


def batch_axes(mesh, global_batch: int):
    """Mesh axes the batch dim shards over, honouring divisibility.

    Prefers the widest sharding (pod, part, data); drops outer axes until
    the global batch divides the product (e.g. long_500k's batch of 1
    replicates).
    """
    shape = plan_of(mesh).shape
    cand = [a for a in ("pod", "part", "data") if a in shape]
    while cand:
        n = 1
        for a in cand:
            n *= shape[a]
        if global_batch % n == 0:
            return tuple(cand)
        cand = cand[1:]
    return ()
