"""The port's SPMD tooling held against the JAX package's, on shapes alone.

The reference's rules read only ``mesh.shape``, so each runs here on a
device-less ``jax.sharding.AbstractMesh`` (``repro.launch.mesh._mk``
patched in this test to build one) and gives its exact specs and shard
shapes, which the port's ``MeshPlan`` rules must equal:

* the production meshes, the batch axes, ``plan_mesh`` and
  ``submesh_plan``;
* ``param_pspecs`` and ``shard_shape`` leaf by leaf for every config at
  full width (params on ``"meta"``), on five meshes, fsdp on and off;
  ``cache_pspecs`` of the decode shapes and the batch specs;
* ``input_specs`` / ``cache_specs`` shapes and dtypes, and the dry run's
  per-device argument bytes of every cell against the sum over the
  reference's ``build_cell`` shard shapes;
* each activation pin's spec against what the reference passes to
  ``_constrain`` (patched) under the same axes.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import mesh as JM
from repro.launch import sharding as JSH
from repro.models import api as japi
from repro.models import pspec as JPS
from repro.runtime import elastic as JEL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.models import api as tapi
from repro_torch.models import pspec as TPS
from repro_torch.runtime import elastic as TEL
from repro_torch.runtime import steps as TRS
from repro_torch.tree import leaves_with_paths

jax.devices()       # the backend is up before the reference's dry run loads
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS)

if _flags is None:   # its 512-device flag must not reach later tests
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags


@pytest.fixture(autouse=True)
def abstract_meshes(monkeypatch):
    monkeypatch.setattr(JM, "_mk", lambda shape, axes: AbstractMesh(
        tuple(shape), tuple(axes)))


def _jpath(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name",
                                                  getattr(p, "idx", p))))
                    for p in path)


def _jflat(tree, is_leaf=None) -> dict:
    return {_jpath(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _jspec(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# meshes and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("partitions", [1, 2, 4, 8, 16, 3])
def test_production_mesh(multi_pod, partitions):
    if partitions == 3:
        with pytest.raises(ValueError) as want:
            JM.make_production_mesh(multi_pod=multi_pod, partitions=3)
        with pytest.raises(ValueError) as got:
            TM.make_production_mesh(multi_pod=multi_pod, partitions=3)
        assert str(got.value) == str(want.value)
        return
    want = JM.make_production_mesh(multi_pod=multi_pod, partitions=partitions)
    got = TM.make_production_mesh(multi_pod=multi_pod, partitions=partitions)
    assert got.names == tuple(want.axis_names)
    assert got.sizes == tuple(want.axis_sizes)
    assert got.shape == dict(want.shape)
    assert list(got.shape) == list(want.shape)      # outer to inner


@pytest.mark.parametrize("partitions", [1, 2, 4, 8, 16, 3, 5])
def test_partition_submesh_and_host_mesh(partitions):
    if 16 % partitions:
        with pytest.raises(ValueError, match="must divide"):
            TM.make_partition_submesh(partitions)
        with pytest.raises(ValueError, match="must divide"):
            JM.make_partition_submesh(partitions)
    else:
        want = JM.make_partition_submesh(partitions)
        assert TM.make_partition_submesh(partitions).shape == dict(want.shape)
    want = JM.make_host_mesh(partitions, 16 // partitions or 1)
    got = TM.make_host_mesh(partitions, 16 // partitions or 1)
    assert got.shape == dict(want.shape)
    assert (TM.POD_CHIPS, TM.DATA_AXIS, TM.MODEL_AXIS, TM.N_PODS) == (
        JM.POD_CHIPS, JM.DATA_AXIS, JM.MODEL_AXIS, JM.N_PODS)


MESHES = [dict(multi_pod=m, partitions=p) for m in (False, True)
          for p in (1, 2, 4, 16)]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_axes(mesh):
    want_mesh = JM.make_production_mesh(**mesh)
    got_mesh = TM.make_production_mesh(**mesh)
    for gb in (1, 2, 8, 32, 128, 256, 512, 1024):
        assert TM.batch_axes(got_mesh, gb) == JM.batch_axes(want_mesh, gb)


def test_device_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        TM.device_mesh(TM.make_host_mesh(1, 1), "cpu")


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


def test_plan_mesh_and_submesh_plan():
    for n in range(1, 601):
        assert TEL.plan_mesh(n) == JEL.plan_mesh(n)
        kw = dict(model_axis=8, prefer_model=False)
        assert _outcome(TEL.plan_mesh, n, **kw) == \
            _outcome(JEL.plan_mesh, n, **kw)
    for n in range(1, 301):
        for p in range(1, 18):
            assert TEL.submesh_plan(n, p) == JEL.submesh_plan(n, p), (n, p)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="cannot mesh"):
            TEL.plan_mesh(bad)


# ---------------------------------------------------------------------------
# parameter, cache and batch specs at full width
# ---------------------------------------------------------------------------


def _both_params(arch):
    """(reference ShapeDtypeStructs, port meta tensors) of ``arch``."""
    jp = jax.eval_shape(japi.build(jget_config(arch)).init,
                        jax.random.PRNGKey(0))
    tp = tapi.build(get_config(arch), "meta").init(torch.Generator())
    return jp, tp


def _stack2_jax(tree):
    return jax.eval_shape(lambda t: JD.RS.stack_tree(t, 2), tree)


# (mesh constructor kwargs or host mesh, stack axis)
PARAM_MESHES = [("single", dict(multi_pod=False), None),
                ("multi", dict(multi_pod=True), None),
                ("single P=2 stacked", dict(partitions=2), "part"),
                ("multi P=2 stacked on pod", dict(multi_pod=True), "pod"),
                ("host (32, 8)", (32, 8), None)]


def _meshes(kw):
    if isinstance(kw, tuple):
        return JM.make_host_mesh(*kw), TM.make_host_mesh(*kw)
    return JM.make_production_mesh(**kw), TM.make_production_mesh(**kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_and_shard_shapes(arch):
    jp, tp = _both_params(arch)
    jp2, tp2 = _stack2_jax(jp), TRS.stack_tree(tp, 2)
    for name, kw, stack in PARAM_MESHES:
        jmesh, tmesh = _meshes(kw)
        jtree, ttree = (jp2, tp2) if stack else (jp, tp)
        tleaf = dict(leaves_with_paths(ttree))
        for fsdp in (True, False):
            want = _jflat(JSH.param_pspecs(jtree, None, jmesh, stack, fsdp),
                          is_leaf=lambda x: isinstance(x, P))
            got = TSH.param_pspecs(ttree, None, tmesh, stack, fsdp)
            assert list(got) == list(want), (name, fsdp)
            jshape = _jflat(jtree)
            for path, spec in got.items():
                assert spec == _jspec(want[path]), (name, fsdp, path)
                shape = tuple(tleaf[path].shape)
                assert shape == tuple(jshape[path].shape), path
                assert TSH.shard_shape(shape, spec, tmesh) == tuple(
                    NamedSharding(jmesh, want[path]).shard_shape(shape)), \
                    (name, fsdp, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs(arch):
    jm, tm = japi.build(jget_config(arch)), tapi.build(get_config(arch),
                                                       "meta")
    for shape_name in applicable_shapes(get_config(arch)):
        jshape, tshape = JSHAPES[shape_name], SHAPES[shape_name]
        jin, tin = jm.input_specs(jshape), tm.input_specs(tshape)
        assert list(tin) == list(jin)
        for k, v in tin.items():
            assert v.is_meta and tuple(v.shape) == tuple(jin[k].shape), k
            assert str(v.dtype).replace("torch.", "") == str(jin[k].dtype), k
        for name, kw, stack in PARAM_MESHES[:4]:
            jmesh, tmesh = _meshes(kw)
            gb = tshape.global_batch
            want = JSH.batch_shardings(jin, jmesh, gb)
            got = TSH.batch_pspecs(tin, tmesh, gb)
            assert {k: tuple(s.spec) for k, s in want.items()} == got, name
            if stack and tshape.kind == "train":
                j2 = {k: jax.ShapeDtypeStruct(
                    (2, v.shape[0] // 2) + v.shape[1:], v.dtype)
                    for k, v in jin.items()}
                t2 = {k: v.reshape((2, v.shape[0] // 2) + v.shape[1:])
                      for k, v in tin.items()}
                want = JSH.batch_shardings(j2, jmesh, gb, stack_axis=stack)
                got = TSH.batch_pspecs(t2, tmesh, gb, stack_axis=stack)
                assert {k: tuple(s.spec) for k, s in want.items()} == got
            if tshape.kind != "decode":
                continue
            jc, tc = jm.cache_specs(jshape), tm.cache_specs(tshape)
            jcl, tcl = _jflat(jc), dict(leaves_with_paths(tc))
            assert list(tcl) == list(jcl)
            for k, v in tcl.items():
                assert v.is_meta and tuple(v.shape) == tuple(jcl[k].shape)
                assert str(v.dtype).replace("torch.", "") == \
                    str(jcl[k].dtype), k
            want = _jflat(JSH.cache_pspecs(jc, None, jmesh, gb),
                          is_leaf=lambda x: isinstance(x, P))
            got = TSH.cache_pspecs(tc, None, tmesh, gb)
            assert got == {k: _jspec(s) for k, s in want.items()}, name
            for k, spec in got.items():
                assert TSH.shard_shape(tuple(tcl[k].shape), spec, tmesh) == \
                    tuple(NamedSharding(jmesh, want[k]).shard_shape(
                        tuple(tcl[k].shape)))


# ---------------------------------------------------------------------------
# the dry run's per-device argument bytes
# ---------------------------------------------------------------------------


def _ref_bytes(arch, shape_name, mesh, partitions):
    _, args, shards, _ = JD.build_cell(arch, shape_name, mesh, partitions,
                                       accum=4, auto_kv=False)
    out = []
    for a, s in zip(args, shards):
        al = jax.tree.leaves(a)
        sl = jax.tree.leaves(s, is_leaf=lambda x: isinstance(x,
                                                             NamedSharding))
        assert len(al) == len(sl)
        out.append(sum(int(np.prod(sh.shard_shape(x.shape))) *
                       x.dtype.itemsize for x, sh in zip(al, sl)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_equal_the_reference_cells(arch):
    cells = [(s, mk, 1) for s in applicable_shapes(get_config(arch))
             for mk in ("single", "multi")]
    cells += [("train_4k", mk, 2) for mk in ("single", "multi")]
    for shape_name, mk, parts in cells:
        kw = dict(multi_pod=mk == "multi", partitions=parts)
        want = _ref_bytes(arch, shape_name, JM.make_production_mesh(**kw),
                          parts)
        rec = TD.run_cell(arch, shape_name, mk, parts, verbose=False)
        assert rec["ok"], rec.get("traceback")
        got = rec["arg_bytes_per_device"]
        assert [got[k] for k in got if k != "total"] == want, \
            (shape_name, mk, parts)
        assert got["total"] == sum(want)
        assert rec["fits_h100"] == (sum(want) <= 80e9)
        assert set(rec["not_measured"]) == {
            "memory.temp", "memory.alias", "cost_analysis", "collectives"}
        assert not {"memory", "cost_analysis", "collectives"} & set(rec)
        mesh = TM.make_production_mesh(**kw)
        assert rec["mesh_shape"] == mesh.shape


def test_dryrun_cli_writes_one_json_a_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TD, "OUT_DIR", tmp_path)
    n_ok, n = TD.main(["--arch", "qwen2-7b", "--shape", "train_4k",
                       "--mesh", "both", "--partitions", "2"])
    assert (n_ok, n) == (2, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen2_7b__train_4k__multi_p2.json",
        "qwen2_7b__train_4k__single_p2.json"]
    assert "dryrun: 2/2 cells OK" in capsys.readouterr().out
    assert TD.main(["--arch", "qwen2-7b", "--shape", "train_4k", "--mesh",
                    "single", "--partitions", "2", "--skip-existing"]) == \
        (1, 1)
    with pytest.raises(SystemExit):
        TD.main(["--arch", "qwen2-7b", "--dump-hlo", "x"])


def test_layout_policy_is_the_reference_s():
    for arch in ARCH_IDS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jp, tp = _both_params(arch)
        for kw in (dict(), dict(multi_pod=True), dict(partitions=4)):
            jmesh, tmesh = _meshes(kw)
            assert TD.serving_layout_fits(tp, tmesh) == \
                JD.serving_layout_fits(jp, jmesh)
            for s in applicable_shapes(tcfg):
                for accum in (1, 4):
                    assert TD.want_seq_shard(tcfg, SHAPES[s], tmesh, accum) \
                        == JD.want_seq_shard(jcfg, JSHAPES[s], jmesh, accum)


# ---------------------------------------------------------------------------
# activation pins
# ---------------------------------------------------------------------------

PIN_AXES = [dict(batch=("data",), model="model", model_size=16),
            dict(batch=("pod", "data"), model="model", model_size=16,
                 seq_shard=False),
            dict(batch=("part", "data"), model="model", model_size=1),
            dict(batch=None, model="model", model_size=16),
            dict(batch=("data",), model=None, model_size=16)]
PIN_SHAPES = [(8,), (8, 32), (8, 48, 64), (8, 40, 64), (16, 8, 64, 128),
              (32, 12, 4, 16), (4, 64, 8, 20)]


@pytest.mark.parametrize("axes", PIN_AXES, ids=str)
def test_pin_specs_equal_the_reference(axes, monkeypatch):
    seen = []
    monkeypatch.setattr(JPS, "_constrain",
                        lambda x, spec: seen.append(list(spec)) or x)
    with JPS.axes(**axes):
        for kind in TPS.KINDS:
            for shape in PIN_SHAPES:
                for dim in ((0, 1, 2) if kind in ("pbatch", "pmodel")
                            else (0,)):
                    seen.clear()
                    x = np.zeros(shape, np.float32)
                    fn = getattr(JPS, kind)
                    out = fn(x, dim) if kind in ("pbatch", "pmodel") \
                        else fn(x)
                    assert out is x
                    got = TPS.pin_spec(
                        kind, shape, dim, batch=axes["batch"],
                        model=axes["model"], model_size=axes["model_size"],
                        seq_shard=axes.get("seq_shard", True))
                    if not seen:
                        assert got is None, (kind, shape, dim)
                        continue
                    want = [TPS.U if e is P.UNCONSTRAINED else e
                            for e in seen[0]]
                    assert got == want, (kind, shape, dim)


def test_pins_are_identity_without_axes_and_on_plain_tensors():
    x = torch.ones(8, 48, 64)
    TPS.clear_axes()
    for kind in TPS.KINDS:
        assert getattr(TPS, kind)(x) is x
    with TPS.axes(batch=("data",), model_size=16):
        assert TPS._BATCH_AXES == ("data",) and TPS._MODEL_SIZE == 16
        for kind in TPS.KINDS:
            assert getattr(TPS, kind)(x) is x
    assert TPS._BATCH_AXES is None and TPS._MODEL_AXIS is None
    with pytest.raises(ValueError, match="unknown pin"):
        TPS.pin_spec("pnothing", (2,), batch=("data",), model="model")


def test_to_placements_keeps_mesh_order_and_raises_out_of_it():
    from torch.distributed.tensor import Replicate, Shard

    plan = TM.make_production_mesh(multi_pod=True, partitions=2)
    assert TSH.to_placements((("pod", "part", "data"), None, "model"),
                             plan) == [Shard(0), Shard(0), Shard(0),
                                       Shard(2)]
    assert TSH.to_placements((), plan) == [Replicate()] * 4
    with pytest.raises(ValueError, match="mesh order"):
        TSH.to_placements((("data", "pod"),), plan)
    with pytest.raises(ValueError, match="named twice"):
        TSH.to_placements(("data", "data"), plan)
    with pytest.raises(ValueError, match="not in the mesh"):
        TSH.to_placements(("expert",), plan)
    with pytest.raises(ValueError, match="not divisible"):
        TSH.shard_shape((10, 4), ("data",), plan)
