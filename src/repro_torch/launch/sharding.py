"""Sharding rules: parameter, batch and cache specs, and their DTensor
placements (the port of ``repro/launch/sharding.py``).

A *spec* is a tuple with one entry per leading tensor dim, entry for entry
what the reference's ``PartitionSpec`` holds: ``None`` (not sharded), an
axis name, or a tuple of two or more axis names (the dim sharded over
their product, major to minor; ``P`` writes a one-axis tuple as the name
and an empty one as None, as ``PartitionSpec`` does); dims past its end
are not sharded.  The rules read only
the mesh's axis sizes (``launch.mesh.plan_of``), so a ``MeshPlan`` at the
production shape gives the reference's specs without a device.  Trees of
specs and placements are flat dicts keyed by the port's leaf paths
(``tree.leaves_with_paths``: dict keys and list indices joined by "/"),
the keys of a checkpoint.

Policy (the reference's, unchanged):
  * params: Megatron-style TP over ``model`` on the feature/expert dim +
    ZeRO-3/FSDP storage over ``data`` on the other dim, with divisibility
    fallbacks (odd vocabs, 25-head configs, ... drop the offending axis).
  * batch dims shard over ("pod", "part", "data"), whichever divide.
  * decode KV caches shard head_dim over ``model``.
  * params stacked on a leading ``part`` / ``pod`` axis (traffic shaping)
    are sharded on that axis.

``to_placements`` turns a spec into one placement a mesh dim: ``Shard(d)``
where the spec names that mesh axis on tensor dim d, else ``Replicate()``.
DTensor splits a tensor dim over several mesh dims in mesh order only, so
a tuple entry out of mesh order raises; it is never reordered.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import batch_axes, plan_of
from repro_torch.tree import leaves_with_paths, unflatten

STACK_KEYS = ("blocks", "enc_blocks", "dec_blocks")
KV_NAMES = ("k", "v", "xk", "xv")


def P(*entries) -> tuple:
    """A spec from its entries, canonical as ``PartitionSpec`` makes them:
    a one-axis tuple becomes the axis name, an empty one None."""
    def one(e):
        if isinstance(e, (tuple, list)):
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in entries)


def _div(shape: dict, n: int, axis: str) -> bool:
    return axis in shape and n % shape[axis] == 0


def _ax(shape: dict, n: int, axis: str):
    return axis if _div(shape, n, axis) else None


def _rule(mesh, name: str, path_names: tuple, shape: tuple,
          fsdp: bool = True) -> tuple:
    """The spec of a single (unstacked) parameter array.

    ``fsdp=False`` = serving layout: params keep only their tensor-parallel
    (model-axis) sharding and replicate over data."""
    ms = plan_of(mesh).shape
    nd = len(shape)
    in_moe = "moe" in path_names

    def mk(*axes):
        if not fsdp:
            axes = tuple(a if a != "data" else None for a in axes)
        return tuple(axes)

    def tp(a0, a1):         # axis a0 on dim 0, a1 on dim 1, where they divide
        return mk(_ax(ms, shape[0], a0), _ax(ms, shape[1], a1))

    if nd == 1:
        # biases / norm scales: shard over model when large & divisible
        if shape[0] >= 1024 and _div(ms, shape[0], "model"):
            return mk("model")
        return ()
    if name == "embed":
        return tp("model", "data")
    if name in ("lm_head", "pos_dec", "wq", "wk", "wv", "in_proj", "ws1",
                "ws3", "router"):
        return tp("data", "model")
    if name in ("wo", "out_proj", "ws2"):
        return tp("model", "data")
    if name in ("w1", "w3") and not in_moe:
        return tp("data", "model")
    if name == "w2" and not in_moe:
        return tp("model", "data")
    if in_moe and name in ("w1", "w3") and nd == 3:
        return mk(_ax(ms, shape[0], "model"), _ax(ms, shape[1], "data"), None)
    if in_moe and name == "w2" and nd == 3:
        return mk(_ax(ms, shape[0], "model"), None, _ax(ms, shape[2], "data"))
    if name == "conv_w":
        return mk(None, _ax(ms, shape[1], "model"))
    if name == "meta":
        return ()
    # generic fallback: model on the largest divisible dim, data on the next
    spec: list = [None] * nd
    order = np.argsort(shape)[::-1]
    for ax_name in (("model", "data") if fsdp else ("model",)):
        for d in order:
            if spec[d] is None and _div(ms, shape[d], ax_name):
                spec[d] = ax_name
                break
    return tuple(spec)


def param_pspecs(params_shape, cfg, mesh, stack_axis: str | None = None,
                 fsdp: bool = True) -> dict:
    """{leaf path: spec} of a params (or optimizer state) tree of tensors,
    meta ones included.  ``stack_axis``: "part" / "pod" when the leaves
    carry a leading per-partition stacking dim (traffic shaping)."""
    out = {}
    for path, x in leaves_with_paths(params_shape):
        names = tuple(path.split("/"))
        shape = tuple(x.shape)
        prefix = []
        if stack_axis is not None:
            prefix.append(stack_axis)
            shape = shape[1:]
        if any(k in names for k in STACK_KEYS):
            prefix.append(None)
            shape = shape[1:]
        out[path] = P(*prefix, *_rule(mesh, names[-1], names, shape,
                                      fsdp=fsdp))
    return out


def batch_pspecs(specs: dict, mesh, global_batch: int,
                 stack_axis=None) -> dict:
    """{name: spec} of an input_specs dict (batch dim leading, after the
    stacking dim when ``stack_axis``)."""
    bax = batch_axes(mesh, global_batch)
    if stack_axis is not None:
        bax = tuple(a for a in bax if a != stack_axis)

    def one(v):
        nd = len(v.shape)
        lead = (stack_axis,) if stack_axis else ()
        return P(*lead, bax if bax else None,
                 *(None,) * (nd - 1 - len(lead)))

    return {k: one(v) for k, v in specs.items()}


def cache_pspecs(cache_shape, cfg, mesh, global_batch: int) -> dict:
    """{leaf path: spec} of a decode cache: batch over the data axes,
    head_dim (K/V) or the state / channel dim (SSM) over ``model``."""
    ms = plan_of(mesh).shape
    bax = batch_axes(mesh, global_batch)
    b = bax if bax else None
    out = {}
    for path, x in leaves_with_paths(cache_shape):
        name = path.split("/")[-1]
        shape = tuple(x.shape)
        if name in KV_NAMES:  # (L, B, S, Hkv, D)
            d_ax = "model" if shape[4] % ms["model"] == 0 else None
            spec = P(None, b, None, None, d_ax)
        elif name == "ssm_state":  # (L, B, H, P, N)
            spec = P(None, b, None, None, _ax(ms, shape[-1], "model"))
        elif name == "ssm_conv":  # (L, B, K-1, C)
            spec = P(None, b, None, _ax(ms, shape[-1], "model"))
        elif name == "len":
            spec = ()
        else:
            spec = (None,) * len(shape)
        out[path] = spec
    return out


# ---------------------------------------------------------------------------
# specs -> shard shapes and DTensor placements
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor laid out by ``spec``;
    raises where a sharded dim does not divide, as the reference's
    ``NamedSharding.shard_shape`` does."""
    ms = plan_of(mesh).shape
    out = list(shape)
    for d, entry in enumerate(spec):
        n = 1
        for a in _axes_of(entry):
            n *= ms[a]
        if out[d] % n:
            raise ValueError(f"shard_shape: dim {d} of {tuple(shape)} is not "
                             f"divisible by {n} ({entry} of {ms})")
        out[d] //= n
    return tuple(out)


def to_placements(spec, mesh) -> list:
    """One DTensor placement a mesh dim, in mesh order: ``Shard(d)`` where
    ``spec`` puts that mesh axis on tensor dim d, else ``Replicate()``.
    Raises on an unknown axis, an axis named twice, or a tuple entry whose
    axes are not in mesh order (DTensor shards a dim over mesh dims in
    mesh order only)."""
    from torch.distributed.tensor import Replicate, Shard

    names = plan_of(mesh).names
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh {names}")
            if a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} named twice")
            seen.add(a)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in mesh order {names}; DTensor cannot "
                             "shard a dim in that order")
        for i in pos:
            out[i] = Shard(d)
    return out


def _pairs(specs: dict, mesh) -> dict:
    return {k: (mesh, to_placements(s, mesh)) for k, s in specs.items()}


def param_shardings(params_shape, cfg, mesh, stack_axis=None,
                    fsdp=True) -> dict:
    """{leaf path: (device mesh, placements)} of a params tree on the
    ``DeviceMesh`` ``mesh``."""
    return _pairs(param_pspecs(params_shape, cfg, mesh, stack_axis,
                               fsdp=fsdp), mesh)


def batch_shardings(specs: dict, mesh, global_batch: int,
                    stack_axis=None) -> dict:
    """{name: (device mesh, placements)} of an input_specs dict."""
    return _pairs(batch_pspecs(specs, mesh, global_batch, stack_axis), mesh)


def cache_shardings(cache_shape, cfg, mesh, global_batch: int,
                    auto_kv: bool = True) -> dict:
    """``auto_kv``: no placement (None) for k/v, where the reference leaves
    the layout to XLA; a caller then keeps them as they are (never
    ``Replicate()``)."""
    specs = cache_pspecs(cache_shape, cfg, mesh, global_batch)
    return {k: (None if auto_kv and k.split("/")[-1] in KV_NAMES
                else (mesh, to_placements(s, mesh)))
            for k, s in specs.items()}


def distribute(tree, shardings: dict):
    """Each leaf of ``tree`` placed by its (device mesh, placements) pair
    (``distribute_tensor`` of the whole leaf); a leaf whose pair is None is
    kept as it is.  Returns a tree of ``tree``'s structure."""
    from torch.distributed.tensor import distribute_tensor

    out = []
    for path, x in leaves_with_paths(tree):
        pair = shardings[path]
        out.append(x if pair is None else distribute_tensor(x, *pair))
    return unflatten(tree, out)
