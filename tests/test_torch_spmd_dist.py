"""The SPMD tooling on real process groups: four gloo ranks on the CPU.

One test starts four ranks (``torch.distributed`` over ``tcp://localhost``,
its own 60 s timeout) on a (data 2, model 2) ``DeviceMesh`` and checks, on
every rank:

* the params of qwen2-7b ``--smoke`` (fp32), placed by ``param_shardings``
  (``sharding.distribute``): each local shard equals the slice of the
  whole tensor at the rank's mesh coordinates, a dim split over several
  axes taken major to minor (the reference's ``PartitionSpec`` order);
* a batch on a (part 2, data 2) mesh, stacked on ``part`` and not;
* the activation pins on DTensors: a pinned dim moves to its axes, an
  unconstrained one keeps its layout, the values stay;
* ``remesh_state`` onto (1, 4) (``distribute_tensor`` of the full tensor)
  and onto the same mesh from the serving layout (``redistribute``), and
  ``CheckpointManager.restore(shardings=)`` onto (1, 4): the values
  unchanged, the placements the new specs'.

The cluster worker's submesh pin (the reference's ``_partition_mesh``)
keeps today's placement on a one-card host and raises with the plan on
hosts of 16 and 128 cards.
"""
import multiprocessing as mp
import queue
import socket
import time
import traceback

import pytest
import torch

from repro_torch.serving.cluster import make_worker_specs
from repro_torch.serving.cluster.worker import WorkerSpec, worker_device

WORLD = 4
TIMEOUT_S = 60


def _slice(full, spec, shape: dict, coord: dict):
    """The block of ``full`` a device at ``coord`` holds under ``spec``."""
    out = full
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * shape[a] + coord[a], n * shape[a]
        size = full.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out


def _check_placed(placed, full, specs, plan, dmesh, what):
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import to_placements
    from repro_torch.tree import leaves_with_paths

    coord = dict(zip(plan.names, dmesh.get_coordinate()))
    want = dict(leaves_with_paths(full))
    for path, x in leaves_with_paths(placed):
        assert isinstance(x, DTensor), (what, path)
        assert list(x.placements) == to_placements(specs[path], plan), \
            (what, path)
        assert torch.equal(x.to_local(), _slice(want[path], specs[path],
                                                plan.shape, coord)), \
            (what, path, coord)
        assert torch.equal(x.full_tensor(), want[path]), (what, path)


def _rank(rank, port, ckpt_dir, out):
    import torch.distributed as dist
    try:
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)

        from repro_torch.ckpt import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.launch import mesh as M
        from repro_torch.launch import sharding as SH
        from repro_torch.models import api as A
        from repro_torch.models import pspec as PS
        from repro_torch.runtime.elastic import remesh_state
        from repro_torch.tree import tree_map

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=WORLD, rank=rank)
        cfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
        params = A.build(cfg, "cpu").init(torch.Generator().manual_seed(0))

        # params on (data 2, model 2)
        plan = M.make_host_mesh(2, 2)
        dm = M.device_mesh(plan, "cpu")
        specs = SH.param_pspecs(params, cfg, plan)
        assert any(len(s) for s in specs.values())
        placed = SH.distribute(params, SH.param_shardings(params, cfg, dm))
        _check_placed(placed, params, specs, plan, dm, "(2, 2)")

        # a batch on (part 2, data 2): stacked on part, and not
        plan_b = M.MeshPlan(("part", "data"), (2, 2))
        dmb = M.device_mesh(plan_b, "cpu")
        toks = torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)
        for batch, stack in (({"tokens": toks.reshape(2, 4, 6)}, "part"),
                             ({"tokens": toks}, None)):
            bs = SH.batch_pspecs(batch, plan_b, 8, stack_axis=stack)
            assert bs["tokens"] == (("part", "data", None) if stack
                                    else (("part", "data"), None))
            placed_b = SH.distribute(batch, SH.batch_shardings(
                batch, dmb, 8, stack_axis=stack))
            _check_placed(placed_b, batch, bs, plan_b, dmb, f"batch {stack}")

        # the pins on a DTensor
        x = distribute_tensor(torch.randn(8, 6, 4,
                                          generator=torch.Generator()
                                          .manual_seed(1)),
                              dm, [Replicate(), Shard(2)])
        full = x.full_tensor()
        with PS.axes(batch=("data",), model_size=2, mesh=dm):
            y = PS.pbatch(x)
            assert list(y.placements) == [Shard(0), Shard(2)]
            z = PS.presidual(x)
            assert list(z.placements) == [Shard(0), Shard(1)]
            assert PS.pmodel(z, 1) is z
            assert torch.equal(y.full_tensor(), full)
            assert torch.equal(z.full_tensor(), full)
        assert PS.pbatch(x) is x                      # no axes set

        # remesh: (2, 2) -> (1, 4), and the serving layout -> fsdp in place
        plan14 = M.make_host_mesh(1, 4)
        dm14 = M.device_mesh(plan14, "cpu")
        moved = remesh_state(placed, cfg, dm, dm14)
        _check_placed(moved, params, SH.param_pspecs(params, cfg, plan14),
                      plan14, dm14, "remesh (1, 4)")
        serving = SH.distribute(params, SH.param_shardings(params, cfg, dm,
                                                           fsdp=False))
        _check_placed(remesh_state(serving, cfg, dm, dm), params, specs,
                      plan, dm, "redistribute (2, 2)")

        # restore a checkpoint onto (1, 4)
        mgr = CheckpointManager(ckpt_dir)
        if rank == 0:
            mgr.save(3, {"params": params})
        dist.barrier()
        template = {"params": tree_map(lambda t: t.to("meta"), params)}
        restored, meta = mgr.restore(template, shardings=SH.param_shardings(
            template, cfg, dm14))
        assert meta["step"] == 3
        _check_placed(restored, {"params": params}, SH.param_pspecs(
            template, cfg, plan14), plan14, dm14, "restore (1, 4)")
        out.put((rank, None))
    except Exception:  # noqa: BLE001 — reported to the test
        out.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_four_gloo_ranks_place_remesh_and_restore(tmp_path):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(tmp_path), out))
             for r in range(WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < WORLD:
            left = TIMEOUT_S - (time.time() - t0)
            assert left > 0, f"timed out after {TIMEOUT_S} s: {results}"
            try:
                rank, err = out.get(timeout=left)
            except queue.Empty:
                continue
            results[rank] = err
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    failed = {r: e for r, e in results.items() if e}
    assert not failed, "\n".join(f"rank {r}:\n{e}" for r, e in failed.items())


# ---------------------------------------------------------------------------
# the cluster worker's submesh pin
# ---------------------------------------------------------------------------


def _spec(**kw):
    spec = make_worker_specs("qwen2-7b", 2, smoke=True, slots=2, max_len=64,
                             peak_flops_total=1e12, engine="real")[1]
    return WorkerSpec(**{**spec.__dict__, **kw})


def test_worker_specs_tell_each_worker_the_fleet_width():
    specs = make_worker_specs("qwen2-7b", 3, smoke=True, slots=2, max_len=64,
                       peak_flops_total=1e12)
    assert [s.partitions for s in specs] == [3, 3, 3]


def test_worker_keeps_its_card_on_a_one_card_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert worker_device(_spec(device="cuda")) == torch.device("cuda", 0)
    assert worker_device(_spec(device="cpu")) == torch.device("cpu")


def test_worker_raises_with_the_plan_on_a_sixteen_card_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 16)
    # one model group of 16: the degraded (1, 16) grid of the elastic path
    with pytest.raises(NotImplementedError, match=r"\(1, 16\)"):
        worker_device(_spec(device="cuda", partitions=2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 128)
    with pytest.raises(NotImplementedError, match=r"\(8, 16\)"):
        worker_device(_spec(device="cuda", partitions=2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 16)
    # partitions that do not divide the data axis: no plan, no pin
    assert worker_device(_spec(device="cuda", partitions=3)) == \
        torch.device("cuda", 1)
