"""The bf16 prefill flash-attention kernel against another version of its
source, on one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.flash_attention_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/flash_attention.cu`` is compiled with the
same ``nvcc`` flags into ``build/kernels/ab/`` and called through the same
C entry point (``fa_launch``) as this checkout's kernel, with or without
the ``causal`` argument and the ``lse`` pointer (null: the serving
call), as its source declares them.  At the serving path's prefill wave
(q (4, 32, 28, 128), k / v (4, 32, 4, 128)) and at a 2048-token prompt (q
(1, 2048, 28, 128)), causal, bf16, at the wave in f32 (the card-versus-CPU
checks' kernel), where OTHER has the mode bidirectional at 4 x 1500 rows
(the enc-dec encoder's length, qwen2-7b's heads and whisper's), and, where
OTHER takes the ``lse`` pointer, the forward with LSE at every family's
training attention (4096 rows a microbatch: qwen2-7b, qwen3-moe,
internvl2, hymba global and windowed, whisper's decoder self and cross
attention), both are held against the plain version (3e-2; the LSE within
3e-2 x (rms + |want|)), compared with each other bit for bit (``bitwise``:
the same kernel arithmetic gives the same bits; this checkout's route,
``fwd_route``, is named beside it), and timed with CUDA events in the
order other, this, this, other.  Prints one line per shape and one JSON
line.
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

BF, F32 = torch.bfloat16, torch.float32
# name: (B, Sq, Skv, Hq, Hkv, D, causal, window, dtype, lse)
SHAPES = {"prefill wave": (4, 32, 32, 28, 4, 128, True, 0, BF, False),
          "long prompt": (1, 2048, 2048, 28, 4, 128, True, 0, BF, False),
          "prefill wave f32": (4, 32, 32, 28, 4, 128, True, 0, F32, False),
          "bidirectional": (4, 1500, 1500, 28, 4, 128, False, 0, BF, False),
          "whisper encoder": (4, 1500, 1500, 8, 8, 64, False, 0, BF, False),
          "train qwen2-7b": (1, 4096, 4096, 28, 4, 128, True, 0, BF, True),
          "train qwen3-moe": (1, 4096, 4096, 32, 4, 128, True, 0, BF, True),
          "train internvl2": (1, 4096, 4096, 48, 8, 128, True, 0, BF, True),
          "train hymba global": (1, 4096, 4096, 25, 5, 64, True, 0, BF,
                                 True),
          "train hymba window": (1, 4096, 4096, 25, 5, 64, True, 1024, BF,
                                 True),
          "train whisper self": (1, 4096, 4096, 8, 8, 64, True, 0, BF, True),
          "train whisper cross": (1, 4096, 1500, 8, 8, 64, False, 0, BF,
                                  True)}
TOLS = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
ITERS = 20


def _other_lib(root: Path):
    """OTHER's library, and whether its ``fa_launch`` takes ``causal`` (a
    source from before the bidirectional mode does not; one from before
    training takes no ``lse`` pointer either)."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    out = _build.BUILD_DIR / "ab" / "libflash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    decl = src.read_text().split('extern "C" int fa_launch', 1)[1]
    head = decl.split("{", 1)[0]
    has_causal, has_lse = "int causal" in head, "lse" in head
    lib = ctypes.CDLL(str(out))
    argtypes = list(fa.SIGNATURES["fa_launch"])
    if not has_causal:
        del argtypes[12]
    if not has_lse:
        del argtypes[4]
    lib.fa_launch.argtypes = argtypes
    lib.fa_launch.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib, has_causal, has_lse


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
    other, has_causal, has_lse = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, Sq, Skv, HQ, HKV, HD, causal, window, dtype,
               lse) in SHAPES.items():
        if not (causal or has_causal) or (lse and not has_lse):
            continue
        q = torch.randn((B, Sq, HQ, HD), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, Skv, HKV, HD), generator=g,
                            device=dev).to(dtype) for _ in range(2))
        o = torch.empty_like(q)
        stat = torch.empty((B, Sq, HQ), device=dev) if lse else None

        def run_other():
            err = other.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(),
                                  *([stat.data_ptr() if lse else None]
                                    if has_lse else []),
                                  B, Sq, Skv, HQ, HKV, HD, window,
                                  *([int(causal)] if has_causal else []),
                                  _build.dtype_code(q), _build.stream_of(q))
            _build.check(other, err, "other fa_launch")
            return (o, stat) if lse else o

        def run_this():
            return fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, lse=lse)

        want, want_lse = ref.attention_lse(q, k, v, causal=causal,
                                           window=window)
        want = want.float()
        tol = TOLS[dtype]
        errs, outs = {}, {}
        for tag, fn in (("other", run_other), ("this", run_this)):
            got, got_lse = fn() if lse else (fn(), None)
            outs[tag] = (got.clone(), None if got_lse is None
                         else got_lse.clone())
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            errs[tag] = float(err.max())
            bad = not torch.isfinite(got.float()).all() or bool(
                (err > tol + tol * want.abs()).any())
            if got_lse is not None:
                rms = float(want_lse.pow(2).mean().sqrt())
                bad = bad or bool(((got_lse - want_lse).abs()
                                   > tol * (rms + want_lse.abs())).any())
            if bad:
                raise SystemExit(f"{tag} kernel disagrees with the plain "
                                 f"version at {name} (max abs err "
                                 f"{errs[tag]:.3g})")
        del want, want_lse
        turns = [("other", _time_ms(run_other)), ("this", _time_ms(run_this)),
                 ("this", _time_ms(run_this)), ("other", _time_ms(run_other))]
        if causal and Sq == Skv:    # the (query, key) pairs each query sees
            n = min(window, Sq) if window else Sq
            pairs = n * (n + 1) / 2 + (Sq - n) * n
        else:
            pairs = Sq * Skv
        flops = 4 * B * HQ * HD * pairs
        r = {tag: [t for n_, t in turns if n_ == tag]
             for tag in ("other", "this")}
        r.update(max_abs_err=errs, route=fa.fwd_route(q, k),
                 bitwise=all(a is None or torch.equal(a, b) for a, b in
                             zip(outs["other"], outs["this"])),
                 tflops={tag: flops / (sum(ts) / len(ts)) / 1e9
                         for tag, ts in r.items()})
        results[name] = r
        mode = "causal" if causal else "bidirectional"
        if window:
            mode += f", window {window}"
        print(f"{name} (q ({B},{Sq},{HQ},{HD}), k/v ({B},{Skv},{HKV},{HD}), "
              f"{mode}, {dtype}{', LSE' if lse else ''}): other ms "
              f"{r['other'][0]:.4f} / {r['other'][1]:.4f}, this ms "
              f"{r['this'][0]:.4f} / {r['this'][1]:.4f} on {r['route']}; "
              f"TFLOP/s other {r['tflops']['other']:.1f} this "
              f"{r['tflops']['this']:.1f}; bit for bit equal: "
              f"{r['bitwise']}", flush=True)
        del q, k, v, o, stat, outs
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]), "shapes": results}), flush=True)


if __name__ == "__main__":
    main()
