"""The conv2d kernels against another version of their source, on one card,
in turns.

  PYTHONPATH=src python -m repro_torch.profiling.conv2d_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/conv2d.cu`` (with the ``common.cuh`` beside
it) is compiled with the same ``nvcc`` flags into ``build/kernels/ab/`` and
called through whichever C entry point it declares: ``conv_run`` with
OTHER's own plan (its ``kernels/conv2d/plan.py``, loaded from its file), or
the earlier ``conv_launch``.

At ResNet-50's 20 distinct conv shapes at 224, batch 64 (recorded at the
conv wrapper of a shape-only forward), in fp32 and bf16: each shape's
timed launches cycle over distinct input sets, together past the 50 MB
L2, as a forward reads each layer's weights once.  Both versions are held
against the plain version (2e-4 fp32, 3e-2 bf16) and timed with CUDA
events in the order other, this, this, other.  Prints one line per shape
(with each side's route: OTHER's plan's, or ``conv_launch``, and this
checkout's; and whether the two outputs are equal bit for bit, as they
must be where both sides run one kernel), one ResNet-50 forward's
53-conv totals per dtype, and one JSON line.  A card is required; without one it raises.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from repro_torch.device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as cv_k
from repro_torch.kernels.conv2d import ops as cv_ops
from repro_torch.kernels.conv2d import ref as cv_ref
from repro_torch.models import cnn

BATCH = 64
ITERS = 8                 # timed launches per turn
L2_SPAN = 128e6           # bytes of input sets a shape cycles over
_P, _I = ctypes.c_void_p, ctypes.c_int


def recording_conv(calls: Counter, conv):
    """A stand-in for ``cnn.conv2d`` that counts each call's shape,
    (H, Cin, Cout, k, stride), in ``calls`` and returns ``conv``'s output."""
    def record(x, w, *, stride=1, padding="SAME"):
        calls[(x.shape[1], w.shape[2], w.shape[3], w.shape[0], stride)] += 1
        return conv(x, w, stride=stride, padding=padding)
    return record


def conv_shapes(name: str):
    """{(H, Cin, Cout, k, stride): calls} of one forward of CNN ``name`` at
    224, recorded at the conv wrapper of a batch-1 forward on the CPU whose
    convs and fcs return zeros of their output shape (the shapes need no
    arithmetic; the fc weights are sized for a 32-pixel input, which the
    zeros ignore)."""
    calls = Counter()

    def zeros(x, w, *, stride, padding):
        return torch.zeros((x.shape[0], -(-x.shape[1] // stride),
                            -(-x.shape[2] // stride), w.shape[3]))

    params = cnn.init_cnn(torch.Generator().manual_seed(0), name, img=32,
                          device="cpu")
    real = cnn.conv2d, cnn.matmul
    cnn.conv2d = recording_conv(calls, zeros)
    cnn.matmul = lambda a, b: torch.zeros((a.shape[0], b.shape[1]))
    try:
        cnn.apply_cnn(params, name, torch.zeros((1, 224, 224, 3)))
    finally:
        cnn.conv2d, cnn.matmul = real
    return dict(calls)


def _other_lib(root: Path):
    """Compile OTHER's conv2d.cu; returns (lib, OTHER's plan module or None
    for the entry point before ``conv_run``)."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "conv2d.cu"
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libconv2d-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's conv2d.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    if "conv_run(" not in src.read_text():
        lib.conv_launch.argtypes = [_P] * 3 + [_I] * 11 + [_P]
        lib.conv_launch.restype = ctypes.c_int
        return lib, None
    lib.conv_run.argtypes = [_P] * 4 + [_I] * 16 + [_P]
    lib.conv_run.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "other_conv2d_plan",
        root / "src" / "repro_torch" / "kernels" / "conv2d" / "plan.py")
    plan = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = plan       # dataclasses look their module up
    spec.loader.exec_module(plan)
    return lib, plan


def _other_plan(plan, x, w, stride):
    """OTHER's plan for these operands, by its own ``plan.py`` (with its
    TMA legality where it has a ``wgmma`` route)."""
    N, Hp, Wp, C = x.shape
    kh, kw, _, K = w.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    bf16 = x.dtype == torch.bfloat16
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tma = ({"tma": plan.tma_legal(C, K, kh, kw, stride, x.data_ptr(),
                                  w.data_ptr(), bf16=bf16)}
           if hasattr(plan, "tma_legal") else {})
    return plan.plan(N * Ho * Wo, K, kh * kw * C, bf16=bf16, n_sm=n_sm,
                     is_aligned=plan.aligned(C, K, x.data_ptr(), w.data_ptr(),
                                             bf16=bf16), **tma)


def _run_other(lib, plan, x, w, stride):
    N, Hp, Wp, C = x.shape
    kh, kw, _, K = w.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    y = torch.empty((N, Ho, Wo, K), dtype=x.dtype, device=x.device)
    code = _build.dtype_code(x)
    if plan is None:
        err = lib.conv_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, Hp,
                              Wp, C, K, kh, kw, stride, Ho, Wo, code,
                              _build.stream_of(x))
    else:
        M = N * Ho * Wo
        p = _other_plan(plan, x, w, stride)
        extra = (plan.weights_scratch(p, kh * kw * C, K,
                                      bf16=x.dtype == torch.bfloat16)
                 if hasattr(plan, "weights_scratch") else 0)
        ws = torch.empty(math.prod(plan.workspace_shape(p, M, K)) + extra,
                         dtype=torch.float32, device=x.device)
        err = lib.conv_run(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                           ws.data_ptr() if ws.numel() else None, N, Hp, Wp,
                           C, K, kh, kw, stride, Ho, Wo,
                           plan.ROUTE_CODES[p.route], p.bm, p.bn, p.splits,
                           p.rows, code, _build.stream_of(x))
    _build.check(lib, err, "other conv2d")
    return y


def _time_ms(fn, n_sets) -> float:
    """Mean device ms of ``fn(i)`` over ITERS launches cycling over the
    input sets, queued behind a ~10 ms spin so that the events bracket
    device work only."""
    fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for i in range(ITERS):
        fn(i % n_sets)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / ITERS


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: python -m repro_torch.profiling.conv2d_ab "
                         "OTHER_CHECKOUT_ROOT")
    dev = resolve("cuda")
    torch.backends.cudnn.allow_tf32 = False
    lib, other_plan = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results, totals = {}, Counter()
    shapes = conv_shapes("resnet50")
    for dt in (torch.float32, torch.bfloat16):
        tol = 2e-4 if dt == torch.float32 else 3e-2
        dname = str(dt).split(".")[1]
        for (H, C, K, k, st), calls in sorted(shapes.items()):
            sets = []
            while len(sets) < 2 or (len(sets) < 4 and len(sets) * sum(
                    t.numel() * t.element_size() for t in sets[0])
                    < L2_SPAN):
                x = torch.randn((BATCH, H, H, C), generator=g, device=dev)
                w = torch.randn((k, k, C, K), generator=g, device=dev) \
                    * math.sqrt(2.0 / (k * k * C))
                sets.append((cv_ops.pad_same(x.to(dt), k, k, st), w.to(dt)))
                del x, w
            n = len(sets)
            xp, w = sets[0]
            want = cv_ref.conv2d(xp, w, stride=st).float()
            errs, outs = {}, {}
            for who, fn in (("other", lambda s: _run_other(
                    lib, other_plan, s[0], s[1], st)),
                            ("this", lambda s: cv_k.conv2d_cuda(
                                s[0], s[1], stride=st))):
                outs[who] = fn(sets[0])
                got = outs[who].float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                errs[who] = float(err.max())
                if not torch.isfinite(got).all() or bool(
                        (err > tol + tol * want.abs()).any()):
                    raise SystemExit(f"{who} kernel disagrees with the plain "
                                     f"version at {(H, C, K, k, st)} {dt} "
                                     f"(max abs err {errs[who]:.3g})")

            def run_other(i):
                return _run_other(lib, other_plan, sets[i][0], sets[i][1], st)

            def run_this(i):
                return cv_k.conv2d_cuda(sets[i][0], sets[i][1], stride=st)

            turns = [("other", _time_ms(run_other, n)),
                     ("this", _time_ms(run_this, n)),
                     ("this", _time_ms(run_this, n)),
                     ("other", _time_ms(run_other, n))]
            r = {who: [t for k_, t in turns if k_ == who]
                 for who in ("other", "this")}
            r.update(max_abs_err=errs, calls=calls,
                     plan=str(cv_k.plan_for(xp, w, stride=st)),
                     routes={"other": "conv_launch" if other_plan is None
                             else _other_plan(other_plan, xp, w, st).route,
                             "this": cv_k.plan_for(xp, w, stride=st).route},
                     bitwise=torch.equal(outs["other"], outs["this"]))
            name = f"{BATCH}x{H}x{H}x{C} -> {K} k{k} s{st} {dname}"
            results[name] = r
            for who in ("other", "this"):
                totals[f"{dname} {who}"] += calls * sum(r[who]) / 2
            print(f"{name} (x{calls}/forward, routes other "
                  f"{r['routes']['other']} / this {r['routes']['this']}, "
                  f"{r['plan']}, bitwise {r['bitwise']}): other ms "
                  f"{r['other'][0]:.4f} / {r['other'][1]:.4f}, this ms "
                  f"{r['this'][0]:.4f} / {r['this'][1]:.4f}", flush=True)
            del sets, xp, w, want
        print(f"one ResNet-50 forward's {sum(shapes.values())} convs, "
              f"{dname}: other ms {totals[f'{dname} other']:.3f}, this ms "
              f"{totals[f'{dname} this']:.3f}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]),
                      "other_has_conv_run": other_plan is not None,
                      "cases": results, "totals": dict(totals)}), flush=True)


if __name__ == "__main__":
    main()
