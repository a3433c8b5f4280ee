"""The bf16 prefill flash-attention kernel against another version of its
source, on one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.flash_attention_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/flash_attention.cu`` is compiled with the
same ``nvcc`` flags into ``build/kernels/ab/`` and called through the same
C entry point (``fa_launch``) as this checkout's kernel, with or without
the ``causal`` argument, as its source declares it.  At the serving
path's prefill wave (q (4, 32, 28, 128), k / v (4, 32, 4, 128)) and at a
2048-token prompt (q (1, 2048, 28, 128)), causal, bf16, both are held
against the plain version (3e-2), compared with each other bit for bit
(``bitwise``: the same kernel arithmetic gives the same bits), and timed
with CUDA events in the order other, this, this, other.  Prints one line
per shape and one JSON line.
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


def _other_lib(root: Path):
    """OTHER's library, and whether its ``fa_launch`` takes ``causal`` (a
    source from before the bidirectional mode does not)."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    out = _build.BUILD_DIR / "ab" / "libflash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    decl = src.read_text().split('extern "C" int fa_launch', 1)[1]
    has_causal = "int causal" in decl.split("{", 1)[0]
    lib = ctypes.CDLL(str(out))
    argtypes = list(fa.SIGNATURES["fa_launch"])
    if not has_causal:
        del argtypes[11]
    lib.fa_launch.argtypes = argtypes
    lib.fa_launch.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib, has_causal


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
    other, has_causal = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, S) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((B, S, HQ, HD), (B, S, HKV, HD), (B, S, HKV, HD)))
        o = torch.empty_like(q)

        def run_other():
            err = other.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), B, S, S, HQ, HKV, HD, 0,
                                  *([1] if has_causal else []),
                                  _build.dtype_code(q), _build.stream_of(q))
            _build.check(other, err, "other fa_launch")
            return o

        def run_this():
            return fa.flash_attention_cuda(q, k, v)

        want = ref.attention(q, k, v).float()
        errs, outs = {}, {}
        for tag, fn in (("other", run_other), ("this", run_this)):
            outs[tag] = fn().clone()
            got = outs[tag].float()
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
        r.update(max_abs_err=errs,
                 bitwise=bool(torch.equal(outs["other"], outs["this"])),
                 tflops={
            tag: flops / (sum(ts) / len(ts)) / 1e9 for tag, ts in r.items()})
        results[name] = r
        print(f"{name} (q ({B},{S},{HQ},{HD}), causal, bf16): other ms "
              f"{r['other'][0]:.4f} / {r['other'][1]:.4f}, this ms "
              f"{r['this'][0]:.4f} / {r['this'][1]:.4f}; TFLOP/s other "
              f"{r['tflops']['other']:.1f} this {r['tflops']['this']:.1f}; "
              f"bit for bit equal: {r['bitwise']}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]), "shapes": results}), flush=True)


if __name__ == "__main__":
    main()
