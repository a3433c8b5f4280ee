"""The flash-attention backward against another version of its source, on
one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.flash_attention_bwd_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` is compiled with
the same ``nvcc`` flags into ``build/kernels/ab/`` and called through its
three C entry points (``fa_bwd_delta_launch``, ``fa_bwd_dkdv_launch``,
``fa_bwd_dq_launch``) with the arguments its source declares: the same as
this checkout's so far, and a source that declares others is refused.  At
qwen2-7b's training shape (q (1, 4096, 28, 128), k / v (1, 4096, 4, 128),
causal), whisper's encoder (q = k = v (4, 1500, 8, 64), bidirectional) and
its cross attention (q (4, 32, 8, 64) over k / v (4, 1500, 8, 64)), bf16,
this checkout's forward writes the log-sum-exp once; then both backwards
are held against the plain backward in f32 on the same inputs (3e-2 x
(rms + |want|) on each of dQ, dK, dV), compared with each other bit for
bit (``bitwise``: false across a redesign, whose sums run in another
order), and timed with CUDA events in the order other, this, this, other:
the three launches together and each kernel alone.  Prints one line per
shape and one JSON line.  A card is required; without one it raises.
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

# name: (B, Sq, Skv, Hq, Hkv, D, causal)
SHAPES = {"train": (1, 4096, 4096, 28, 4, 128, True),
          "whisper encoder": (4, 1500, 1500, 8, 8, 64, False),
          "whisper cross": (4, 32, 1500, 8, 8, 64, False)}
TOL = 3e-2
ITERS = 10


def _other_lib(root: Path):
    """OTHER's library, its entry points declared as this checkout's."""
    src = (root / "src" / "repro_torch" / "kernels" / "csrc"
           / "flash_attention_bwd.cu")
    text = src.read_text()
    for fn, argtypes in fa.BWD_SIGNATURES.items():
        head = text.split(f'extern "C" int {fn}(', 1)[1].split(")", 1)[0]
        if head.count(",") + 1 != len(argtypes):
            raise SystemExit(f"{src}: {fn} takes {head.count(',') + 1} "
                             f"arguments, this checkout's {len(argtypes)}")
    out = _build.BUILD_DIR / "ab" / "libflash_attention_bwd-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fa.BWD_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _time_ms(fn) -> float:
    """Mean device ms of ``fn()`` over ITERS calls queued behind a ~10 ms
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


def _ratio(got, want) -> float:
    """Largest |got - want| / (TOL (rms(want) + |want|))."""
    w = want.float()
    rms = float(w.pow(2).mean().sqrt())
    return float(((got.float() - w).abs() / (TOL * (rms + w.abs()))).max())


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: python -m repro_torch.profiling."
                         "flash_attention_bwd_ab OTHER_CHECKOUT_ROOT")
    dev = resolve("cuda")
    other = _other_lib(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, Sq, Skv, Hq, Hkv, D, causal) in SHAPES.items():
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                     (B, Skv, Hkv, D), (B, Sq, Hq, D)))
        _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, lse=True)
        want = ref.attention_backward(*(t.float() for t in (q, k, v, do)),
                                      causal=causal)
        sides = {tag: fa.flash_attention_bwd_launches(
            q, k, v, lse, do, causal=causal, lib=lib)
            for tag, lib in (("other", other), ("this", None))}
        ratios, outs = {}, {}
        for tag, (out, launches) in sides.items():
            for run in launches.values():
                run()
            torch.cuda.synchronize()
            outs[tag] = [t.clone() for t in out]
            ratios[tag] = {n: _ratio(a, b) for n, a, b in
                           zip(("dq", "dk", "dv"), out, want)}
            if not all(torch.isfinite(t.float()).all() for t in out) or \
                    max(ratios[tag].values()) > 1:
                raise SystemExit(f"{tag} backward disagrees with the plain "
                                 f"version at {name}: {ratios[tag]} of the "
                                 f"bound {TOL} x (rms + |want|)")
        del want

        def whole(launches):
            return lambda: [run() for run in launches.values()]

        turns = {"other": [], "this": []}
        kernel_ms = {"other": {}, "this": {}}
        for tag in ("other", "this", "this", "other"):
            launches = sides[tag][1]
            turns[tag].append(_time_ms(whole(launches)))
            for kname, run in launches.items():
                kernel_ms[tag].setdefault(kname, []).append(_time_ms(run))
        pairs = (Sq * (Sq + 1) / 2 if causal and Sq == Skv else Sq * Skv)
        flops = 2.5 * 4 * B * Hq * D * pairs      # FA2's 5 products a pair
        r = dict(turns, kernel_ms=kernel_ms, bound_ratio=ratios,
                 bitwise=all(torch.equal(a, b) for a, b in
                             zip(outs["other"], outs["this"])),
                 tflops={tag: flops / (sum(ts) / len(ts)) / 1e9
                         for tag, ts in turns.items()})
        results[name] = r
        mode = "causal" if causal else "bidirectional"
        per = "; ".join(
            f"{kname} other {sum(kernel_ms['other'][kname]) / 2:.4f} this "
            f"{sum(kernel_ms['this'][kname]) / 2:.4f}"
            for kname in fa.BWD_KERNELS)
        print(f"{name} (q ({B},{Sq},{Hq},{D}), k/v ({B},{Skv},{Hkv},{D}), "
              f"{mode}, bf16): other ms {r['other'][0]:.4f} / "
              f"{r['other'][1]:.4f}, this ms {r['this'][0]:.4f} / "
              f"{r['this'][1]:.4f}; TFLOP/s at 2.5x the forward's FLOPs "
              f"other {r['tflops']['other']:.1f} this "
              f"{r['tflops']['this']:.1f}; by kernel (ms, mean of two) "
              f"{per}; worst fraction of the bound other "
              f"{max(ratios['other'].values()):.3f} this "
              f"{max(ratios['this'].values()):.3f}; bit for bit equal: "
              f"{r['bitwise']}", flush=True)
        del q, k, v, do, lse, sides, outs
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]), "shapes": results}), flush=True)


if __name__ == "__main__":
    main()
