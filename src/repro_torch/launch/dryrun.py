"""Multi-pod dry run on meta tensors: every (arch x shape x mesh) cell's
arguments, laid out by the sharding rules, without a device (the port of
``repro/launch/dryrun.py``).

For each cell this driver:
  1. builds the step function (train / prefill / decode) and its
     arguments on ``"meta"`` (shapes and dtypes, no storage): params,
     ``adamw_init``, ``stack_tree`` when partitioned, the input and cache
     specs, as the reference's ``build_cell`` does;
  2. lays each argument out by ``launch.sharding`` on the production mesh
     plan (``serving_layout_fits`` and ``want_seq_shard``, the
     reference's layout policy, copied with its thresholds);
  3. writes one JSON a cell under ``build/dryrun_torch/``: the mesh shape,
     the batch axes, the layout variants, the per-device argument bytes by
     part and their total, whether they fit one H100's 80 GB, and
     ``model_flops`` with its per-device compute term at the H100's peak.

What the reference reads from XLA's compiled program (temp and alias
memory, ``cost_analysis``, collective bytes from the HLO) has no
counterpart here, since nothing is compiled: those keys are absent, listed
under ``not_measured``, never zero.  There is no compile to choose
between the two layout variants either, so both are listed; the bytes
are priced on the variant that places every argument (``auto_kv=False``
for decode: under ``auto_kv`` the reference leaves k/v to XLA; the
``seq_shard`` variants pin activations only and leave the arguments
alone).  The reference's ``--dump-hlo`` is dropped: there is no HLO.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
      --partitions 4          # paper-technique partitioned program + sync
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.core import hw, roofline
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import api as mapi
from repro_torch.optim import adamw_init
from repro_torch.runtime import steps as RS
from repro_torch.tree import leaves, leaves_with_paths

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
NOT_MEASURED = ["memory.temp", "memory.alias", "cost_analysis",
                "collectives"]
# smallest first: decode < prefill < train, small models first
SIZE_RANK = ["whisper_base", "mamba2_130m", "hymba_1p5b", "qwen1p5_4b",
             "qwen2_7b", "mistral_nemo_12b", "internvl2_26b",
             "qwen3_moe_30b_a3b", "dbrx_132b", "qwen1p5_110b"]
KIND_RANK = {"decode_32k": 0, "long_500k": 0, "prefill_32k": 1,
             "train_4k": 2}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def serving_layout_fits(params, mesh) -> bool:
    """True when model-sharded-only (TP) weights fit comfortably per device
    (serving layout: replicate over data, move activations not weights).
    The reference's 8 GiB threshold, kept for parity."""
    total = sum(_nbytes(x) for x in leaves(params))
    return total / mesh.shape.get("model", 1) <= 8 * 2**30


def want_seq_shard(cfg, shape, mesh, accum: int) -> bool:
    """Sequence-parallel residuals only when the saved layer carries would
    otherwise exceed the reference's 8 GiB threshold."""
    if shape.kind != "train":
        return False
    n_data = 1
    for a in ("pod", "part", "data"):
        n_data *= mesh.shape.get(a, 1)
    b_dev = max(shape.global_batch // max(accum, 1) // n_data, 1)
    carries = cfg.n_layers * b_dev * shape.seq_len * cfg.d_model * 2
    return carries > 8 * 2**30


def build_cell(arch: str, shape_name: str, mesh, partitions: int = 1,
               accum: int = 4, auto_kv: bool = True):
    """Returns (fn, args, specs, parts) for the cell: the step function,
    its arguments as trees of meta tensors, each argument's {leaf path:
    spec} (None where the reference leaves the layout to XLA), and the
    argument names by part ("params", "optimizer", "batch", "cache")."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    api = mapi.build(cfg, "meta")
    params = api.init(torch.Generator())

    stack = None
    if partitions > 1:
        stack = "part" if "part" in mesh.shape else "pod"

    if shape.kind == "train":
        opt = adamw_init(params)
        in_specs = api.input_specs(shape)
        if partitions > 1:
            n = partitions
            params = RS.stack_tree(params, n)
            opt = RS.stack_tree(opt, n)
            in_specs = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                        for k, v in in_specs.items()}
            fn = RS.make_partitioned_train_step(api, stack_axis=stack,
                                                accum=accum)
        else:
            fn = RS.make_train_step(api, accum=accum)
        p_spec = SH.param_pspecs(params, cfg, mesh, stack_axis=stack)
        o_spec = SH.param_pspecs(opt, cfg, mesh, stack_axis=stack)
        # AdamWState.step: scalar (or (P,) when stacked)
        o_spec["step"] = (stack,) if stack else ()
        b_spec = SH.batch_pspecs(in_specs, mesh, shape.global_batch,
                                 stack_axis=stack)
        return (fn, (params, opt, in_specs), (p_spec, o_spec, b_spec),
                ("params", "optimizer", "batch"))

    p_spec = SH.param_pspecs(params, cfg, mesh)

    if shape.kind == "prefill":
        in_specs = api.input_specs(shape)
        b_spec = SH.batch_pspecs(in_specs, mesh, shape.global_batch)
        fn = RS.make_prefill_step(api, shape.seq_len)
        return (fn, (params, in_specs), (p_spec, b_spec),
                ("params", "batch"))

    # decode: serving layout when TP-only weights fit; the cache layout is
    # XLA's in the reference under auto_kv (no spec here)
    if shape.kind == "decode" and serving_layout_fits(params, mesh):
        p_spec = SH.param_pspecs(params, cfg, mesh, fsdp=False)
    tok = {"token": api.input_specs(shape)["token"]}
    cache = api.cache_specs(shape)
    c_spec = SH.cache_pspecs(cache, cfg, mesh, shape.global_batch)
    if auto_kv:
        c_spec = {k: (None if k.split("/")[-1] in SH.KV_NAMES else s)
                  for k, s in c_spec.items()}
    t_spec = SH.batch_pspecs(tok, mesh, shape.global_batch)
    fn = RS.make_decode_step(api)
    return (fn, (params, tok, cache), (p_spec, t_spec, c_spec),
            ("params", "batch", "cache"))


def arg_bytes(args, specs, mesh) -> list:
    """Per-device bytes of each argument: each leaf's shard shape under its
    spec times its element size."""
    out = []
    for tree, spec in zip(args, specs):
        n = 0
        for path, x in leaves_with_paths(tree):
            n += math.prod(SH.shard_shape(tuple(x.shape), spec[path], mesh)) \
                * x.element_size()
        out.append(n)
    return out


def active_params(cfg, params) -> tuple:
    """(all, active a token): an MoE's routed experts count top_k of E."""
    n = sum(x.numel() for x in leaves(params))
    if not cfg.n_experts:
        return n, n
    experts = sum(x.numel() for path, x in leaves_with_paths(params)
                  if "/moe/" in f"/{path}" and path.split("/")[-1] in
                  ("w1", "w2", "w3"))
    return n, int(n - experts * (1 - cfg.top_k / cfg.n_experts))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             partitions: int = 1, verbose: bool = True,
             accum: int = 4) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "partitions": partitions, "accum": accum, "ok": False}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    partitions=partitions)
        rec["mesh_shape"] = dict(mesh.shape)
        shape = SHAPES[shape_name]
        cfg = get_config(arch)
        bax = batch_axes(mesh, shape.global_batch)
        if partitions > 1:
            stackax = "part" if "part" in mesh.shape else "pod"
            bax = tuple(a for a in bax if a != stackax)
        rec["batch_axes"] = list(bax)
        if shape.kind == "decode":
            variants = [{"auto_kv": True}, {"auto_kv": False}]
            priced = {"auto_kv": False}
        else:
            base_ss = want_seq_shard(cfg, shape, mesh, 4)
            variants = [{"seq_shard": base_ss}, {"seq_shard": not base_ss}]
            priced = variants[0]
        rec["variants"] = variants
        rec["variant_priced"] = priced
        fn, args, specs, parts = build_cell(
            arch, shape_name, mesh, partitions, accum=accum,
            auto_kv=priced.get("auto_kv", True))
        by_part = dict(zip(parts, arg_bytes(args, specs, mesh)))
        total = sum(by_part.values())
        rec["arg_bytes_per_device"] = dict(by_part, total=total)
        rec["fits_h100"] = total <= hw.H100_HBM_GB * 1e9
        n_all, n_active = active_params(cfg, args[0])
        if partitions > 1 and shape.kind == "train":
            n_all //= partitions
            n_active //= partitions
        flops = roofline.model_flops(cfg, n_all, n_active, shape)
        terms = roofline.RooflineTerms(flops=flops / mesh.size)
        rec.update(n_params=n_all, n_active=n_active, model_flops=flops,
                   n_devices=mesh.size,
                   compute_s_per_device_h100=terms.times()["compute_s"],
                   not_measured=list(NOT_MEASURED))
        rec["build_s"] = round(time.time() - t0, 3)
        rec["ok"] = True
        if verbose:
            print(f"OK  {arch:>18s} {shape_name:>12s} {mesh_kind:>6s} "
                  f"P={partitions} args/dev={total / 2**30:.2f}GiB "
                  f"fits_h100={rec['fits_h100']} "
                  f"model_flops={flops:.3e}")
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"FAIL {arch} {shape_name} {mesh_kind} P={partitions}: "
                  f"{rec['error'][:200]}")
    return rec


def cell_path(arch, shape, mesh_kind, partitions=1) -> Path:
    p = f"_p{partitions}" if partitions > 1 else ""
    return OUT_DIR / f"{canonical(arch)}__{shape}__{mesh_kind}{p}.json"


def cells_of(arch, shape, mesh: str, all_cells: bool) -> list:
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    if all_cells:
        cells = [(a, s, mk) for a in ARCH_IDS
                 for s in applicable_shapes(get_config(a)) for mk in meshes]
        rank = {a: i for i, a in enumerate(SIZE_RANK)}
        cells.sort(key=lambda c: (KIND_RANK[c[1]], rank[c[0]]))
        return cells
    shapes = [shape] if shape else applicable_shapes(get_config(arch))
    return [(arch, s, mk) for s in shapes for mk in meshes]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--accum", type=int, default=4)
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch or --all")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cells = cells_of(args.arch, args.shape, args.mesh, args.all)
    n_ok = 0
    for arch, shape, mk in cells:
        path = cell_path(arch, shape, mk, args.partitions)
        if args.skip_existing and path.exists():
            rec = json.loads(path.read_text())
            if rec.get("ok"):
                n_ok += 1
                continue
        rec = run_cell(arch, shape, mk, args.partitions, accum=args.accum)
        path.write_text(json.dumps(rec, indent=1))
        n_ok += rec["ok"]
    print(f"dryrun: {n_ok}/{len(cells)} cells OK in "
          f"{time.time() - t0:.2f} s ({OUT_DIR})")
    return n_ok, len(cells)


if __name__ == "__main__":
    main()
