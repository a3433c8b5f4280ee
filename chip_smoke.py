#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one NVIDIA H100 and hold it to account.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

0. Build every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one process per
   source, in parallel) into ``build/kernels/``.
1. Kernels against their plain PyTorch versions, on the card, at the
   serving path's qwen2-7b shapes in bf16 (tolerance 3e-2, the reference's
   bf16 tolerance) and fp32 (tolerance 2e-4, the reference's fp32
   tolerance: both sides accumulate in f32, only in another order, with
   TF32 switched off explicitly), plus one ragged shape per kernel; then
   each kernel's time beside its plain version's, one PyTorch library
   call's (a yardstick the port never calls) and its roofline bound.
2. Card against CPU: a 2-layer qwen2-7b at full width in fp32, the same
   weights on both; ragged prefill and 4 paged decode steps; logits within
   1e-3 (f32 on both sides, summed in different orders through two layers
   with contractions up to 18,944 long) and identical argmax.
3. The slice: ``repro_torch.launch.serve.main`` serves qwen2-7b at full
   width (28 layers, bf16, random weights from seed 0) with 2 partitions;
   every request must complete and every kernel's launch count must rise.

The second-to-last line is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the port's
sources beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BW = 3.35e12            # HBM3 bytes/s, data sheet
H100_BF16 = 989e12           # dense bf16 tensor-core FLOP/s, data sheet
TOL = {"bfloat16": 3e-2, "float32": 2e-4}
MODEL_TOL = 1e-3

SERVE_ARGS = ["--arch", "qwen2-7b", "--partitions", "2", "--stagger",
              "demand", "--requests", "8", "--batch", "4", "--prompt-len",
              "32", "--gen", "16", "--device", "cuda"]
SLOTS, PROMPT, GEN = 4, 32, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, n_args: int, iters: int = 20) -> float:
    """Mean device ms of ``fn(i)`` over ``iters`` launches cycling over
    ``n_args`` input sets (distinct buffers keep the L2 cold, as on the
    serving path where each layer's weights are read once per step).
    The card first spins for ~10 ms so that the host has queued every
    launch before the start event fires: the events then bracket device
    work only, not the wrappers' host cost (tens of microseconds a call,
    more than some of these kernels take)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for i in range(iters):
        fn(i % n_args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(byts: float, flops: float, peak: float):
    tb, tf = byts / H100_BW, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def check_close(torch, name, got, want, tol):
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    worst = float(err.max())
    if not torch.isfinite(got.float()).all() or bool((err > lim).any()):
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{worst:.3g}, tolerance {tol} abs + {tol} rel)")
    return worst


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, cfg):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, hd, Hq, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    # (K, N, calls per decode step) of every projection and the LM head
    proj = [(d, Hq * hd, 2 * cfg.n_layers),          # wq, wo (square)
            (d, Hkv * hd, 2 * cfg.n_layers),         # wk, wv
            (d, cfg.d_ff, 2 * cfg.n_layers),         # w1, w3
            (cfg.d_ff, d, cfg.n_layers),             # w2
            (d, cfg.vocab, 1)]                       # LM head
    out = {}

    # -- matmul: correctness at decode (M = slots) and prefill (M = slots x
    # prompt) widths, bf16 and fp32, plus a ragged shape
    worst = 0.0
    for M in (SLOTS, SLOTS * PROMPT):
        for K, N, _ in proj:
            for dt in (torch.bfloat16, torch.float32):
                a, b = rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))
                e = check_close(torch, f"matmul {M}x{K}x{N} {dt}",
                                mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                                TOL[str(dt).split(".")[1]])
                if dt == torch.bfloat16:
                    worst = max(worst, e)
                del a, b
    for M, K, N in ((37, 1000, 517), (5, 3583, 130), (129, 100, 70)):
        for dt in (torch.bfloat16, torch.float32):
            a, b = rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))
            check_close(torch, f"matmul ragged {M}x{K}x{N} {dt}",
                        mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                        TOL[str(dt).split(".")[1]])
    log(f"phase 1: matmul matches its plain version at {2 * len(proj)} "
        f"main-path shapes and 3 ragged ones (bf16 max abs err {worst:.3g})")

    # -- matmul timing: one decode step's projections + LM head (M = 4)
    ms = plain = lib = bnd = 0.0
    for K, N, calls in proj:
        a = rnd((SLOTS, K), torch.bfloat16)
        n_buf = max(1, min(16, int(256e6 // (K * N * 2)) + 1))
        bs = [rnd((K, N), torch.bfloat16, 1 / math.sqrt(K))
              for _ in range(n_buf)]
        t_k = time_ms(torch, lambda i: mm_ops.matmul(a, bs[i]), n_buf)
        t_p = time_ms(torch, lambda i: mm_ref.matmul(a, bs[i]), n_buf, 5)
        t_l = time_ms(torch, lambda i: torch.matmul(a, bs[i]), n_buf)
        b_ms, _ = bound(2 * (SLOTS * K + K * N + SLOTS * N),
                        2 * SLOTS * K * N, H100_BF16)
        log(f"  matmul bf16 {SLOTS}x{K}x{N} (x{calls}/step): kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} bound_ms "
            f"{b_ms:.4f}")
        ms += calls * t_k
        plain += calls * t_p
        lib += calls * t_l
        bnd += calls * b_ms
        del a, bs
    for K, N, _ in proj[:-1]:   # a prefill wave's projections, for the record
        a = rnd((SLOTS * PROMPT, K), torch.bfloat16)
        b = rnd((K, N), torch.bfloat16, 1 / math.sqrt(K))
        t_k = time_ms(torch, lambda i: mm_ops.matmul(a, b), 1, 5)
        t_l = time_ms(torch, lambda i: torch.matmul(a, b), 1, 5)
        b_ms, by = bound(2 * (SLOTS * PROMPT * (K + N) + K * N),
                         2 * SLOTS * PROMPT * K * N, H100_BF16)
        log(f"  matmul bf16 {SLOTS * PROMPT}x{K}x{N} (prefill): kernel_ms "
            f"{t_k:.4f} library_ms {t_l:.4f} bound_ms {b_ms:.4f} ({by})")
        del a, b
    out["matmul"] = dict(
        shape=f"one decode step: {7 * cfg.n_layers + 1} calls at M={SLOTS} "
              f"(28 x q,k,v,o,w1,w3,w2 + LM head), bf16",
        max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=bnd, bound_by="bytes")
    log(f"  matmul decode step: kernel_ms {ms:.3f} plain_ms {plain:.3f} "
        f"library_ms {lib:.3f} bound_ms {bnd:.3f}")

    # -- flash attention: the prefill wave (slots x prompt), GQA G = 7
    worst = 0.0
    cases = [(SLOTS, PROMPT, PROMPT, Hq, Hkv, hd, 0, "main"),
             (2, 45, 45, Hq, Hkv, hd, 16, "ragged+window"),
             (3, 29, 29, 4, 2, 16, 0, "D=16")]
    for B, Sq, Skv, hq, hkv, D, w, tag in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (rnd((B, Sq, hq, D), dt), rnd((B, Skv, hkv, D), dt),
                       rnd((B, Skv, hkv, D), dt))
            e = check_close(torch, f"flash_attention {tag} {dt}",
                            fa_ops.flash_attention(q, k, v, window=w),
                            fa_ref.attention(q, k, v, window=w),
                            TOL[str(dt).split(".")[1]])
            if tag == "main" and dt == torch.bfloat16:
                worst = e
    q = rnd((SLOTS, PROMPT, Hq, hd), torch.bfloat16)
    k = rnd((SLOTS, PROMPT, Hkv, hd), torch.bfloat16)
    v = rnd((SLOTS, PROMPT, Hkv, hd), torch.bfloat16)
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()                 # SDPA layout
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_k = time_ms(torch, lambda i: fa_ops.flash_attention(q, k, v), 1)
    t_p = time_ms(torch, lambda i: fa_ref.attention(q, k, v), 1)
    t_l = time_ms(torch, lambda i: sdpa(qt, kt, vt, is_causal=True), 1)
    pairs = PROMPT * (PROMPT + 1) / 2
    b_ms, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                     4 * SLOTS * Hq * hd * pairs, H100_BF16)
    out["flash_attention"] = dict(
        shape=f"one layer of a prefill wave: q ({SLOTS},{PROMPT},{Hq},{hd}), "
              f"k/v ({SLOTS},{PROMPT},{Hkv},{hd}), causal, bf16",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=b_ms, bound_by=by)
    log(f"phase 1: flash_attention matches at {len(cases)} shapes x 2 dtypes;"
        f" kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} "
        f"(SDPA on K/V expanded to {Hq} heads) bound_ms {b_ms:.5f} ({by})")

    # -- paged decode: the slots' chains at the serving path's widths
    bs = 16
    worst = 0.0
    cases = [([PROMPT + 3, PROMPT + 9, PROMPT + 1, PROMPT + 14], 0, Hq, Hkv,
              hd, "main"),
             ([0, 5, 37, 63], 20, Hq, Hkv, hd, "ragged+window+inactive"),
             ([3, 17, 40], 0, 4, 2, 16, "D=16")]
    for curs, w, hq, hkv, D, tag in cases:
        B = len(curs)
        T = max(-(-(c + 1) // bs) for c in curs) + 1      # null-padded tail
        N = 1 + B * T
        free = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
            B)).add(1).tolist()
        tables = torch.zeros((B, T), dtype=torch.int32)
        for b_, c in enumerate(curs):
            if c > 0:       # slot with cur_pos 0 stays on the null block
                for t in range(-(-(c + 1) // bs)):
                    tables[b_, t] = free.pop()
        tables = tables.to(dev)
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            qd = rnd((B, hq, D), dt)
            kp, vp = rnd((N, bs, hkv, D), dt), rnd((N, bs, hkv, D), dt)
            e = check_close(torch, f"paged_decode {tag} {dt}",
                            pa_ops.paged_decode(qd, kp, vp, tables, cur,
                                                window=w),
                            pa_ref.paged_decode_attention(qd, kp, vp, tables,
                                                          cur, window=w),
                            TOL[str(dt).split(".")[1]])
            if tag == "main" and dt == torch.bfloat16:
                worst = e
                main = (qd, kp, vp, tables, cur)
    qd, kp, vp, tables, cur = main
    t_k = time_ms(torch, lambda i: pa_ops.paged_decode(qd, kp, vp, tables,
                                                       cur), 1)
    t_p = time_ms(torch, lambda i: pa_ref.paged_decode_attention(
        qd, kp, vp, tables, cur), 1)
    rows = float((cur + 1).sum())
    b_ms, by = bound(2 * (2 * qd.numel() + 2 * rows * Hkv * hd)
                     + 4 * (tables.numel() + cur.numel()),
                     4 * Hq * hd * rows, H100_BF16)
    out["paged_decode"] = dict(
        shape=f"one layer of a decode step: q ({SLOTS},{Hq},{hd}), pool of "
              f"{kp.shape[0]} blocks x {bs}, contexts {cur.tolist()}, bf16",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=None,
        bound_ms=b_ms, bound_by=by)
    log(f"phase 1: paged_decode matches at {len(cases)} shapes x 2 dtypes; "
        f"kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms null bound_ms "
        f"{b_ms:.5f} ({by})")
    return out


# ---------------------------------------------------------------------------
# phase 2: the card against the CPU on the same full-width weights
# ---------------------------------------------------------------------------


def phase_card_vs_cpu(torch, cfg):
    from repro_torch.models import transformer as TF
    from repro_torch.serving import kv_pool as KV

    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(2)
    params = {"cuda": TF.init_lm(cfg2, g, "cuda")}

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    params["cpu"] = to_cpu(params["cuda"])
    lens = [PROMPT, 20, 27, 9]
    bs, max_len = 16, PROMPT + 16
    T = -(-max_len // bs)
    pool = KV.BlockPool(1 + len(lens) * T, bs)
    tables = torch.tensor([pool.alloc(T) for _ in lens], dtype=torch.int32)
    tokens = torch.randint(1, cfg2.vocab, (len(lens), PROMPT),
                           generator=torch.Generator().manual_seed(3))
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params[dev]
        lg, cache = TF.prefill(p, cfg2, {"tokens": tokens.to(dev)},
                               max_len=max_len, lens=torch.tensor(lens))
        pages = KV.init_pages(cfg2, pool.n_blocks, bs, device=dev)
        KV.write_prefix_pages(pages, cache["k"], cache["v"], tables.to(dev))
        steps = [lg.cpu()]
        tok = lg.argmax(-1)
        pc = dict(pages, tables=tables.to(dev),
                  lens=torch.tensor(lens, dtype=torch.int32, device=dev))
        for _ in range(4):
            lg, pc = TF.decode_step_paged(p, cfg2, tok[:, None], pc)
            lg = lg[:, 0]
            steps.append(lg.cpu())
            tok = lg.argmax(-1)
        logits[dev] = steps
    worst = 0.0
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            fail(f"card vs CPU: argmax differs at step {i}")
        worst = max(worst, check_close(torch, f"card vs CPU step {i}", a, b,
                                       MODEL_TOL))
    log(f"phase 2: 2-layer full-width fp32 model, card (kernels) vs CPU "
        f"(plain): prefill + 4 paged decode steps agree (max abs logit err "
        f"{worst:.3g}, tolerance {MODEL_TOL}), identical argmax")


# ---------------------------------------------------------------------------
# phase 3: the slice, through the serving CLI
# ---------------------------------------------------------------------------


def phase_serve(torch, cfg, wrappers):
    from repro_torch.launch import serve

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    tokens = sum(len(s) for s in outs)
    if tokens != n_req * GEN:
        fail(f"serve: {tokens} tokens generated, expected {n_req} requests x "
             f"{GEN} (a request did not complete)")
    if any(not 0 <= t < cfg.vocab for s in outs for t in s):
        fail("serve: a generated token is outside the vocabulary")
    for name, n in launches.items():
        if n == 0:
            fail(f"serve: kernel {name} was never launched on the main path")
    log(f"phase 3: served {n_req}/{n_req} requests, {tokens} tokens in "
        f"{wall:.2f} s wall ({tokens / wall:.1f} generated tokens per wall "
        f"second), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{launches}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"phase 0: built {sorted(report)} in {time.perf_counter() - t0:.1f} s"
        f" ({_build.BUILD_DIR})")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("qwen2-7b")
    stats = phase_kernels(torch, cfg)
    phase_card_vs_cpu(torch, cfg)
    torch.cuda.empty_cache()
    wrappers = {"matmul": mm_ops.matmul,
                "flash_attention": fa_ops.flash_attention,
                "paged_decode": pa_ops.paged_decode}
    launches = phase_serve(torch, cfg, wrappers)

    meta = {"matmul": ("matmul.cu", "src/repro/kernels/matmul/matmul.py:49"),
            "flash_attention": (
                "flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:92"),
            "paged_decode": (
                "paged_attention.cu",
                "src/repro/kernels/paged_attention/paged_attention.py:101")}
    kernels = []
    for name, (src, replaces) in meta.items():
        s = stats[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"], "shape": s["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
