"""Activation-sharding pins for model internals (the port of
``repro/models/pspec.py``).

A launcher sets the ambient axes with ``set_axes(batch=..., mesh=...)``
(or the ``axes(...)`` context); model code calls ``pbatch(x, dim)``,
``pmodel(x, dim)``, ``presidual(x)``, ``pexpert(x)`` and ``pkv(x)``.  Each
pin's spec is the reference's, computed by the pure ``pin_spec``: one
entry a tensor dim, ``U`` (unconstrained: the dim keeps its layout) or
the mesh axes the dim is pinned to.

A pin redistributes a DTensor on the mesh dims its spec names: a pinned
dim is split over exactly the named axes (in mesh order, as DTensor
splits a dim), an unconstrained dim keeps what it had, and a mesh dim the
spec does not name keeps its placement unless it split a pinned dim (then
it replicates).  A plain tensor, or any tensor while no axes are set,
comes back unchanged: on one card every pin is the identity.  The pins
are not yet called from ``models/`` (ROADMAP.md, the multi-card item).
"""
from __future__ import annotations

from contextlib import contextmanager

_BATCH_AXES: tuple | None = None
_MODEL_AXIS: str | None = None
_MODEL_SIZE: int = 1
_SEQ_SHARD: bool = True  # sequence-parallel residual stream (layer carries)
_MESH = None             # the DeviceMesh the pins act on (None: the tensor's)


class _Unconstrained:
    def __repr__(self):
        return "U"


U = _Unconstrained()     # the reference's ``P.UNCONSTRAINED``
KINDS = ("pbatch", "pmodel", "presidual", "pexpert", "pkv")


def set_axes(batch=None, model="model", model_size: int = 1,
             seq_shard: bool = True, mesh=None):
    global _BATCH_AXES, _MODEL_AXIS, _MODEL_SIZE, _SEQ_SHARD, _MESH
    _BATCH_AXES = tuple(batch) if batch else None
    _MODEL_AXIS = model
    _MODEL_SIZE = model_size
    _SEQ_SHARD = seq_shard
    _MESH = mesh


def clear_axes():
    set_axes(None, None)


@contextmanager
def axes(batch=None, model="model", model_size: int = 1, seq_shard=True,
         mesh=None):
    global _BATCH_AXES, _MODEL_AXIS, _MODEL_SIZE, _SEQ_SHARD, _MESH
    old = (_BATCH_AXES, _MODEL_AXIS, _MODEL_SIZE, _SEQ_SHARD, _MESH)
    set_axes(batch, model, model_size, seq_shard, mesh)
    try:
        yield
    finally:
        _BATCH_AXES, _MODEL_AXIS, _MODEL_SIZE, _SEQ_SHARD, _MESH = old


def pin_spec(kind: str, shape, dim: int = 0, *, batch, model,
             model_size: int = 1, seq_shard: bool = True):
    """The spec the reference's pin ``kind`` constrains a ``shape`` tensor
    to under these axes (``batch`` a tuple or None), or None where that
    pin leaves the tensor as it is."""
    nd = len(shape)
    msz = max(model_size, 1)
    if kind == "pbatch":
        if batch is None or nd <= dim:
            return None
        spec = [U] * nd
        spec[dim] = batch
        return spec
    if kind == "pmodel":
        if batch is None or model is None or nd <= dim:
            return None
        spec = [U] * nd
        spec[dim] = model
        return spec
    if kind == "presidual":
        if batch is None or nd != 3:
            return None
        spec = [batch, U, U]
        if (seq_shard and model is not None and shape[1] % msz == 0
                and model_size > 1):
            spec[1] = model
        return spec
    if kind == "pexpert":
        if batch is None or model is None or nd < 2:
            return None
        spec = [U] * nd
        if shape[0] % msz == 0 and model_size > 1:
            spec[0] = model
        spec[1] = batch
        return spec
    if kind == "pkv":
        if batch is None or nd != 4:
            return None
        spec = [batch, U, U, U]
        if model is not None and model_size > 1 and shape[3] % model_size == 0:
            spec[3] = model
        return spec
    raise ValueError(f"unknown pin {kind!r}; expected one of {KINDS}")


def _constrain(x, spec):
    """``x`` redistributed so that each pinned dim of ``spec`` is split
    over exactly its axes; a plain tensor unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.sharding import to_placements

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if _MESH is not None and mesh != _MESH:
        raise ValueError("pin: the tensor's device mesh is not the one "
                         "set_axes was given")
    pinned = [d for d, e in enumerate(spec) if e is not U]
    wanted = to_placements([None if e is U else e for e in spec], mesh)
    out = list(x.placements)
    for i, p in enumerate(out):
        if isinstance(wanted[i], Shard):
            out[i] = wanted[i]
        elif isinstance(p, Shard) and p.dim % x.ndim in pinned:
            out[i] = Replicate()
    if out == list(x.placements):
        return x
    return x.redistribute(mesh, out)


def _pin(kind, x, dim=0):
    spec = pin_spec(kind, tuple(x.shape), dim, batch=_BATCH_AXES,
                    model=_MODEL_AXIS, model_size=_MODEL_SIZE,
                    seq_shard=_SEQ_SHARD)
    return x if spec is None else _constrain(x, spec)


def pbatch(x, dim: int = 0):
    """Pin ``dim`` to the batch mesh axes; all other dims unconstrained, so
    they keep their tensor-parallel layout."""
    return _pin("pbatch", x, dim)


def pmodel(x, dim: int = 0):
    """Pin ``dim`` to the model axis (others unconstrained)."""
    return _pin("pmodel", x, dim)


def presidual(x):
    """Residual stream (B, S, d) at layer boundaries: batch over the batch
    axes + sequence over the model axis (sequence parallelism) when
    ``seq_shard`` and S divides."""
    return _pin("presidual", x)


def pexpert(x):
    """MoE dispatch buffers (E, C, ...): E over model, capacity over the
    batch axes."""
    return _pin("pexpert", x)


def pkv(x):
    """Decode KV cache slice (B, S, H, D): batch over the batch axes,
    head_dim over model."""
    return _pin("pkv", x)
