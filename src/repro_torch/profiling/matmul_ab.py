"""The matmul kernels against another version of their source, on one card,
in turns.

  PYTHONPATH=src python -m repro_torch.profiling.matmul_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/matmul.cu`` (with the ``common.cuh`` beside
it) is compiled with the same ``nvcc`` flags into ``build/kernels/ab/`` and
called through its own C entry points: ``mm_run`` with OTHER's own plan
(its ``kernels/matmul/plan.py``, loaded from its file) where OTHER has
them, else the earlier ``mm_splits`` (OTHER's own split) and
``mm_launch``.

At qwen2-7b's widths, bf16: the five shapes of a decode step (M = 4 slots:
wq / wo, wk / wv, w1 / w3, w2, the LM head), the four of a prefill wave
(M = 128, 4 slots x 32 prompt tokens) and of a slot refill (M = 32, one
prompt; and M = 64, the lever runs' longer prompt), then the CNNs' fp32 fc
at the
paper's batch (64 x 2048 x 1000, ResNet-50's), then the bf16 products
whose rows are not 16 bytes (``STAGED``): hymba-1.5b's SSM in_proj (N =
3257) at a decode step's M = 4, a 4 x 160-row wave's 640 and a training
microbatch's 4096, and the LM heads of hymba (32,001 columns), internvl2
(92,553) and whisper-base (51,865) at M = 4 and at their training M (a
loss chunk's 248 / 256 rows, whisper's 4096 decoder rows).  Each shape's
timed launches cycle over distinct weight buffers, together past the 50
MB L2, as on the serving path where each layer's weights are read once a
step.  Both versions are held against the plain version (3e-2 bf16, 2e-4
fp32), compared with each other bit for bit (``bitwise``; expected where
both run the same kernel, not across a route change: this checkout's plan
may send a wave's products to the ``stream`` or ``wgmma`` route) and timed with
CUDA events in the order other, this, this, other.  Where OTHER has the
warpgroup route too (``matmul_wgmma.cu``'s ``mm_wgmma_run``), it is
compiled beside it and qwen2-7b's four training products at a
microbatch's 4096 rows (``WGMMA``) are run on both, each as ``MatMul``
issues it: the forward, dA = dC B^T and dB = A^T dC with the transposes
as views, by this checkout's plan; held, compared bit for bit and timed
the same way.  Prints one line per shape, the decode step's 197-call and
the prefill wave's 196-call totals, and one JSON line.  A card is
required; without one it raises.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import matmul as mm_k
from repro_torch.kernels.matmul import ref as mm_ref

SLOTS, PROMPT, CNN_BATCH = 4, 32, 64
# (arch, what, K or None for d_model, N or None for the vocabulary, Ms)
STAGED = (("hymba-1.5b", "in_proj", None, 3257, (SLOTS, SLOTS * 160, 4096)),
          ("hymba-1.5b", "head", None, None, (SLOTS, 248)),
          ("internvl2-26b", "head", None, None, (SLOTS, 256)),
          ("whisper-base", "head", None, None, (SLOTS, 4096)))
# qwen2-7b's training products (K, N) at a microbatch's rows
WGMMA = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
WGMMA_ROWS = 4096
ITERS = 20
L2_SPAN = 256e6              # bytes of weight buffers a shape cycles over
_P, _I = ctypes.c_void_p, ctypes.c_int


def _shapes():
    """(tag, M, K, N, dtype, calls) of the cases, calls per decode step or
    prefill wave (0: timed alone)."""
    cfg = get_config("qwen2-7b")
    d, L = cfg.d_model, cfg.n_layers
    proj = [(d, cfg.n_heads * cfg.head_dim, 2 * L),
            (d, cfg.n_kv_heads * cfg.head_dim, 2 * L),
            (d, cfg.d_ff, 2 * L), (cfg.d_ff, d, L), (d, cfg.vocab, 1)]
    out = [("decode", SLOTS, K, N, torch.bfloat16, c) for K, N, c in proj]
    for tag, M in (("prefill", SLOTS * PROMPT), ("refill", PROMPT),
                   ("refill 64", 2 * PROMPT)):
        out += [(tag, M, K, N, torch.bfloat16, c) for K, N, c in proj[:-1]]
    out.append(("cnn fc", CNN_BATCH, 2048, 1000, torch.float32, 0))
    for arch, what, K, N, ms in STAGED:
        c = get_config(arch)
        out += [(f"staged {arch} {what}", M, K or c.d_model, N or c.vocab,
                 torch.bfloat16, 0) for M in ms]
    return out


def _other_lib(root: Path):
    """Compile OTHER's matmul.cu; returns (lib, OTHER's plan module or None
    for the entry points before ``mm_run``)."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu"
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libmatmul-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's matmul.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    if "mm_run(" not in src.read_text():
        lib.mm_splits.argtypes = [_I] * 4
        lib.mm_splits.restype = ctypes.c_int
        lib.mm_launch.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.mm_launch.restype = ctypes.c_int
        return lib, None
    lib.mm_run.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    lib.mm_run.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "other_matmul_plan",
        root / "src" / "repro_torch" / "kernels" / "matmul" / "plan.py")
    plan = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = plan       # dataclasses look their module up
    spec.loader.exec_module(plan)
    return lib, plan


def _other_wgmma(root: Path):
    """OTHER's matmul_wgmma.cu compiled, or None where it has none."""
    src = (root / "src" / "repro_torch" / "kernels" / "csrc"
           / "matmul_wgmma.cu")
    if not src.exists() or "mm_wgmma_run(" not in src.read_text():
        return None
    out = _build.BUILD_DIR / "ab" / "libmatmul_wgmma-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's matmul_wgmma.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    fn = "mm_wgmma_run"
    getattr(lib, fn).argtypes = mm_k.WG_SIGNATURES[fn]
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def _run_other_wgmma(lib, a, b, p):
    """``a @ b`` by plan ``p`` through OTHER's ``mm_wgmma_run``, with the
    arguments this checkout's wrapper passes."""
    M, K = a.shape
    N = b.shape[1]
    ta, tb = mm_k._tma(a), mm_k._tma(b)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty(mm_k.mm_plan.workspace_shape(p, M, N),
                     dtype=torch.float32, device=a.device)
    err = lib.mm_wgmma_run(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           ws.data_ptr() if p.splits > 1 else None, M, N, K,
                           ta[1], tb[1], int(ta[0]), int(not tb[0]), p.bn,
                           p.splits, p.rows, _build.stream_of(a))
    _build.check(lib, err, "other mm_wgmma_run")
    return c


def _wgmma_cases(lib, g, dev) -> dict:
    """Each training product's forward, dA and dB on OTHER's and this
    checkout's warpgroup kernel: held, bit for bit, timed in turns."""
    out = {}
    for K, N in WGMMA:
        M = WGMMA_ROWS
        a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=g, device=dev)
             / math.sqrt(K)).to(torch.bfloat16)
        dc = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
        for what, x, y in (("forward", a, w), ("dA", dc, w.t()),
                           ("dB", a.t(), dc)):
            p = mm_k.plan_for(x, y)
            if p.route != "wgmma":
                raise SystemExit(f"{what} {M}x{K}x{N}: plan {p}, not wgmma")
            want = mm_ref.matmul(x, y).float()
            outs = {"other": _run_other_wgmma(lib, x, y, p),
                    "this": mm_k.launch(x, y, p)}
            torch.cuda.synchronize()
            for who, got in outs.items():
                err = (got.float() - want).abs()
                if not torch.isfinite(got.float()).all() or bool(
                        (err > 3e-2 + 3e-2 * want.abs()).any()):
                    raise SystemExit(f"{who} wgmma disagrees with the plain "
                                     f"version at {what} {M}x{K}x{N}")
            runs = {"other": lambda i: _run_other_wgmma(lib, x, y, p),
                    "this": lambda i: mm_k.launch(x, y, p)}
            turns = [(who, _time_ms(runs[who], 1))
                     for who in ("other", "this", "this", "other")]
            r = {who: [t for k, t in turns if k == who] for who in runs}
            r.update(bitwise=torch.equal(outs["other"], outs["this"]),
                     plan=str(p))
            name = f"wgmma {what} {M}x{K}x{N} bf16"
            out[name] = r
            print(f"{name} ({r['plan']}): other ms {r['other'][0]:.4f} / "
                  f"{r['other'][1]:.4f}, this ms {r['this'][0]:.4f} / "
                  f"{r['this'][1]:.4f}; outputs bit for bit: {r['bitwise']}",
                  flush=True)
            del want, outs
        del a, w, dc
        torch.cuda.empty_cache()
    return out


def _run_other(lib, plan, a, b):
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    code = _build.dtype_code(a)
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    if plan is not None:
        p = plan.plan(M, N, K, bf16=a.dtype == torch.bfloat16,
                      is_aligned=plan.aligned(N, K, a.data_ptr(),
                                              b.data_ptr()), n_sm=n_sm)
        ws = torch.empty(plan.workspace_shape(p, M, N),
                         dtype=torch.float32, device=a.device)
        err = lib.mm_run(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                         ws.data_ptr() if p.splits > 1 else None, M, N, K,
                         plan.ROUTE_CODES[p.route], p.bm, p.splits,
                         p.rows, code, _build.stream_of(a))
    else:
        splits = lib.mm_splits(M, N, K, n_sm)
        ws = torch.empty((splits, M, N) if splits > 1 else (0,),
                         dtype=torch.float32, device=a.device)
        err = lib.mm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            ws.data_ptr() if splits > 1 else None, M, N, K,
                            splits, code, _build.stream_of(a))
    _build.check(lib, err, "other matmul")
    return c


def _time_ms(fn, n_sets) -> float:
    """Mean device ms of ``fn(i)`` over ITERS launches cycling over the
    weight buffers, queued behind a ~10 ms spin so that the events bracket
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
        raise SystemExit("usage: python -m repro_torch.profiling.matmul_ab "
                         "OTHER_CHECKOUT_ROOT")
    dev = resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, other_plan = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results, totals = {}, {}
    for tag, M, K, N, dt, calls in _shapes():
        a = torch.randn((M, K), generator=g, device=dev).to(dt)
        n_buf = max(1, min(16, int(L2_SPAN // (K * N * a.element_size()))
                           + 1))
        bs = [(torch.randn((K, N), generator=g, device=dev)
               / math.sqrt(K)).to(dt) for _ in range(n_buf)]
        tol = 3e-2 if dt == torch.bfloat16 else 2e-4
        want = mm_ref.matmul(a, bs[0]).float()
        errs, outs = {}, {}
        for who, fn in (("other", lambda b: _run_other(lib, other_plan, a,
                                                       b)),
                        ("this", lambda b: mm_k.matmul_cuda(a, b))):
            outs[who] = fn(bs[0])
            got = outs[who].float()
            torch.cuda.synchronize()
            errs[who] = float((got - want).abs().max())
            if not torch.isfinite(got).all() or bool(
                    ((got - want).abs() > tol + tol * want.abs()).any()):
                raise SystemExit(f"{who} kernel disagrees with the plain "
                                 f"version at {M}x{K}x{N} {dt} (max abs err "
                                 f"{errs[who]:.3g})")

        def run_other(i):
            return _run_other(lib, other_plan, a, bs[i])

        def run_this(i):
            return mm_k.matmul_cuda(a, bs[i])

        turns = [("other", _time_ms(run_other, n_buf)),
                 ("this", _time_ms(run_this, n_buf)),
                 ("this", _time_ms(run_this, n_buf)),
                 ("other", _time_ms(run_other, n_buf))]
        r = {who: [t for k, t in turns if k == who] for who in ("other",
                                                              "this")}
        r.update(max_abs_err=errs, calls=calls,
                 bitwise=torch.equal(outs["other"], outs["this"]),
                 plan=str(mm_k.plan_for(a, bs[0])))
        name = f"{tag} {M}x{K}x{N} {str(dt).split('.')[1]}"
        results[name] = r
        for who in ("other", "this"):
            key = (tag, who)
            totals[key] = totals.get(key, 0.0) + calls * sum(r[who]) / 2
        print(f"{name} ({r['plan']}): other ms {r['other'][0]:.4f} / "
              f"{r['other'][1]:.4f}, this ms {r['this'][0]:.4f} / "
              f"{r['this'][1]:.4f}; outputs bit for bit: {r['bitwise']}",
              flush=True)
        del a, bs
    wg_lib = _other_wgmma(Path(args[0]))
    if wg_lib is not None:
        results.update(_wgmma_cases(wg_lib, g, dev))
    for tag in ("decode", "prefill", "refill", "refill 64"):
        n = sum(c for t, *_, c in _shapes() if t == tag)
        print(f"{tag} total ({n} calls): other ms "
              f"{totals[(tag, 'other')]:.3f}, this ms "
              f"{totals[(tag, 'this')]:.3f}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]),
                      "other_has_mm_run": other_plan is not None,
                      "cases": results,
                      "totals": {f"{t} {w}": v for (t, w), v in
                                 totals.items()
                                 if t in ("decode", "prefill", "refill",
                                          "refill 64")}}),
          flush=True)


if __name__ == "__main__":
    main()
