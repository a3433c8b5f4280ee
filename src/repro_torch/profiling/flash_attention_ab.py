"""The bf16 prefill flash-attention kernel against another version of its
source, on one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.flash_attention_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/flash_attention.cu`` is compiled with the
same ``nvcc`` flags into ``build/kernels/ab/`` and called through the same
C entry point (``fa_launch``) as this checkout's kernel.  At the serving
path's prefill wave (q (4, 32, 28, 128), k / v (4, 32, 4, 128)) and at a
2048-token prompt (q (1, 2048, 28, 128)), causal, bf16, both are held
against the plain version (3e-2) and timed with CUDA events in the order
other, this, this, other.  Prints one line per shape and one JSON line.
A card is required; without one it raises.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref

SHAPES = {"prefill wave": (4, 32), "long prompt": (1, 2048)}   # (B, S)
HQ, HKV, HD = 28, 4, 128        # qwen2-7b's heads and head width
TOL = 3e-2
ITERS = 20


def _other_lib(root: Path) -> ctypes.CDLL:
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    out = _build.BUILD_DIR / "ab" / "libflash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fa.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _time_ms(fn) -> float:
    """Mean device ms of ``fn()`` over ITERS launches queued behind a ~10 ms
    spin, so that the events bracket device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(ITERS):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / ITERS


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: python -m repro_torch.profiling."
                         "flash_attention_ab OTHER_CHECKOUT_ROOT")
    dev = resolve("cuda")
    other = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, S) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((B, S, HQ, HD), (B, S, HKV, HD), (B, S, HKV, HD)))
        o = torch.empty_like(q)

        def run_other():
            err = other.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), B, S, S, HQ, HKV, HD, 0,
                                  _build.dtype_code(q), _build.stream_of(q))
            _build.check(other, err, "other fa_launch")
            return o

        def run_this():
            return fa.flash_attention_cuda(q, k, v)

        want = ref.attention(q, k, v).float()
        errs = {}
        for tag, fn in (("other", run_other), ("this", run_this)):
            got = fn().float()
            torch.cuda.synchronize()
            errs[tag] = float((got - want).abs().max())
            if not torch.isfinite(got).all() or bool(
                    ((got - want).abs() > TOL + TOL * want.abs()).any()):
                raise SystemExit(f"{tag} kernel disagrees with the plain "
                                 f"version at {name} (max abs err "
                                 f"{errs[tag]:.3g})")
        turns = [("other", _time_ms(run_other)), ("this", _time_ms(run_this)),
                 ("this", _time_ms(run_this)), ("other", _time_ms(run_other))]
        flops = 4 * B * HQ * HD * S * (S + 1) / 2
        r = {tag: [t for n, t in turns if n == tag] for tag in ("other", "this")}
        r.update(max_abs_err=errs, tflops={
            tag: flops / (sum(ts) / len(ts)) / 1e9 for tag, ts in r.items()})
        results[name] = r
        print(f"{name} (q ({B},{S},{HQ},{HD}), causal, bf16): other ms "
              f"{r['other'][0]:.4f} / {r['other'][1]:.4f}, this ms "
              f"{r['this'][0]:.4f} / {r['this'][1]:.4f}; TFLOP/s other "
              f"{r['tflops']['other']:.1f} this {r['tflops']['this']:.1f}",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]), "shapes": results}), flush=True)


if __name__ == "__main__":
    main()
