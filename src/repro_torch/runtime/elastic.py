"""Elastic scaling: rebuild the mesh and re-place the state when the device
fleet changes (the port of ``repro/runtime/elastic.py``).  Partitioning
makes this first-class: losing a pod = dropping one partition
(``PartitionRuntime.drop_partition``); losing cards within a pod requires
a remesh and a re-placement, done here.

Recovery flow on failure:
  1. ``plan_mesh(n_devices)``: the largest (data, model) grid the
     survivors support (model axis preserved if possible: param specs stay
     valid);
  2. restore the last checkpoint placed for the new mesh
     (``CheckpointManager.restore(..., shardings=...)``), or
     ``remesh_state`` a live state;
  3. batch divisibility re-checked via ``mesh.batch_axes``; the global
     batch is kept by raising gradient accumulation
     (``accum_for_batch``).
"""
from __future__ import annotations

from repro_torch.launch import sharding as SH
from repro_torch.tree import leaves_with_paths, unflatten


def plan_mesh(n_devices: int, model_axis: int = 16, prefer_model: bool = True):
    """Largest usable (data, model) factorization of the surviving fleet."""
    if n_devices < 1:
        raise ValueError(f"cannot mesh {n_devices} devices")
    m = model_axis
    while prefer_model and m > 1 and n_devices % m:
        m //= 2
    data = n_devices // m
    if data < 1:
        raise ValueError(f"cannot mesh {n_devices} devices")
    usable = data * m
    return (data, m), usable


def submesh_plan(n_local_devices: int, partitions: int, *,
                 data_axis: int = 16, model_axis: int = 16):
    """The (data, model) grid one cluster worker should pin, or None.

    A worker serving one of ``partitions`` compute partitions pins the full
    per-partition synchronous group when its host has the devices for it;
    a host that lost cards pins the largest ``plan_mesh`` grid its
    survivors support *with the model axis preserved* (param shardings stay
    valid), so it re-joins degraded rather than not at all.  None means
    default placement: partitions that don't divide the data axis, or a
    host where even one model group does not fit (a one-card host).
    """
    if partitions <= 1 or data_axis % partitions:
        return None
    full = (data_axis // partitions, model_axis)
    if n_local_devices >= full[0] * full[1]:
        return full
    if n_local_devices < model_axis:
        return None
    (data, m), _usable = plan_mesh(n_local_devices, model_axis=model_axis)
    if m != model_axis:
        return None
    return (min(data, full[0]), m)


def remesh_state(state, cfg, old_mesh, new_mesh):
    """Re-place a (params / optimizer) tree of DTensors or tensors, laid out
    on ``old_mesh``, by ``param_shardings`` on the ``DeviceMesh``
    ``new_mesh``: ``redistribute`` where a leaf already lives on
    ``new_mesh``, else ``distribute_tensor`` of its full tensor (every rank
    of the group takes part)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    del old_mesh        # each DTensor carries its own
    new = SH.param_shardings(state, cfg, new_mesh)
    out = []
    for path, x in leaves_with_paths(state):
        mesh, placements = new[path]
        if isinstance(x, DTensor) and x.device_mesh == mesh:
            out.append(x.redistribute(mesh, placements))
            continue
        full = x.full_tensor() if isinstance(x, DTensor) else x
        out.append(distribute_tensor(full, mesh, placements))
    return unflatten(state, out)


def accum_for_batch(global_batch: int, old_devices: int, new_devices: int,
                    accum: int) -> int:
    """Keep the global batch when the fleet shrinks: scale microbatching."""
    scale = max(1, round(old_devices / max(new_devices, 1)))
    return accum * scale
