"""Generate a measured-cost calibration profile (JSON) with the port's cost
model: the port's counterpart of ``tools/make_reference_profile.py``.

The profile is SYNTHETIC, as the reference tool's is: each shape bucket's
"measured" duration is the analytic duration of
``repro_torch.profiling.MeasuredCostModel`` skewed per phase (prefill
1.35x slower, decode 0.8x faster than the roofline claims), observed
``min_samples`` times so every bucket is warm.  Regenerating with the same
flags reproduces the file byte for byte (sorted keys, no timestamps).
The CLI prices the architecture's smoke-scale config at one H100's bf16
peak (``core.hw.H100_PEAK_FLOPS``) split over ``--workers`` and writes
to ``--out``; given the reference
tool's peak, ``build_reference_model`` reproduces the committed
``docs/profiles/qwen2_7b_smoke*.json`` byte for byte (a CPU test holds
it).

  python tools/torch_make_reference_profile.py --out /tmp/qwen2_7b_smoke.json
  python tools/torch_make_reference_profile.py --arch qwen2-7b --workers 4 \\
      --slots 4 --prompt-len 32 --gen 16 --kv-dtype int8 --out PATH

Replay it, e.g.:

  PYTHONPATH=src python -m repro_torch.launch.cluster --arch qwen2-7b \\
      --smoke --device cpu --simulated --cost-model measured --profile PATH
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PREFILL_SKEW = 1.35
DECODE_SKEW = 0.8


def build_reference_model(cfg, peak_flops: float, *, slots: int,
                          prompt_len: int, gen: int,
                          kv_dtype: str = "fp32", sparse_keep: float = 1.0):
    """A warm ``MeasuredCostModel`` whose EMAs are the analytic durations
    under the per-phase skew, covering every shape bucket the default
    serving load touches (batch 1..slots, the full decode context ramp).
    ``kv_dtype`` / ``sparse_keep`` bake a KV-layout variant into the
    profile: its skewed durations come from the variant's analytic
    decomposition, so a replayed variant profile prices the reduced KV
    traffic."""
    from repro_torch.profiling import MeasuredCostModel, PhaseTimer

    model = MeasuredCostModel(cfg, peak_flops, timer=PhaseTimer(),
                              kv_dtype=kv_dtype, sparse_keep=sparse_keep)
    ana = model.analytic
    prefix = (cfg.n_meta_tokens or 0) + (cfg.n_img_tokens or 0)
    n_obs = model._store.min_samples
    for b in range(1, slots + 1):
        d = ana.prefill(b, prompt_len).duration * PREFILL_SKEW
        for _ in range(n_obs):
            model.observe("prefill", b, prompt_len, d)
    for step in range(gen + 1):
        for b in range(1, slots + 1):
            ctxs = [prefix + prompt_len + step] * b
            d = ana.decode(ctxs).duration * DECODE_SKEW
            for _ in range(n_obs):
                model.observe("decode", b, sum(ctxs), d)
    return model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--workers", type=int, default=4,
                    help="fleet size the profile is calibrated at "
                         "(peak_flops = one H100's bf16 peak / workers)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "int8", "fp8"],
                    help="bake a quantized-KV pricing variant into the "
                         "profile")
    ap.add_argument("--sparse-keep", type=float, default=1.0,
                    help="bake a blockwise-sparse keep fraction (0, 1] "
                         "into the profile's decode pricing")
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="output path")
    args = ap.parse_args(argv)
    if args.workers < 1 or args.slots < 1:
        ap.error("--workers and --slots must be >= 1")
    if not 0.0 < args.sparse_keep <= 1.0:
        ap.error(f"--sparse-keep must be in (0, 1] (got {args.sparse_keep})")

    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.profiling import save_profile

    cfg = get_config(args.arch, smoke=True)
    model = build_reference_model(
        cfg, hw.H100_PEAK_FLOPS / args.workers, slots=args.slots,
        prompt_len=args.prompt_len, gen=args.gen,
        kv_dtype=args.kv_dtype, sparse_keep=args.sparse_keep)
    out = save_profile(model, args.out)
    print(f"wrote {out}: {model.n_warm} warm buckets, "
          f"{model.n_observations} observations "
          f"(prefill x{PREFILL_SKEW}, decode x{DECODE_SKEW}, "
          f"kv {args.kv_dtype}, keep {args.sparse_keep:g})")


if __name__ == "__main__":
    main()
