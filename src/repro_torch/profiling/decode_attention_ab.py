"""The four decode-attention kernels against another version of their
sources, on one card, in turns.

  PYTHONPATH=src python -m repro_torch.profiling.decode_attention_ab OTHER

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``src/repro_torch/kernels/csrc/paged_attention.cu`` and ``flash_decode.cu``
(with the ``decode_attention.cuh`` beside them) are compiled with the same
``nvcc`` flags into ``build/kernels/ab/`` and called through the same C
entry points (``pa_launch``, ``pa_quant_launch``, ``pa_sparse_launch``,
``fd_launch``) as this checkout's kernels.  Entry points from before the
split walk (no workspace, no ``splits`` argument) are recognised from the
source and called as they were; later ones get this checkout's split plan.

At qwen2-7b's widths (4 slots, 28 query heads, 4 kv heads, d_head 128,
bf16 q, blocks of 16) and the main path's contexts (the serve run's 34-47
on a float pool; the lever runs' 66-72 on an int8 pool with a keep mask
and current rows, on a float pool with a keep mask, and on a dense slab,
in bf16 and f32), then at contexts of about 4,096 (float pool; int8 pool
with current rows and no mask; float pool with about half the blocks
kept; dense slab), and on the dense slabs of whisper-base (8 heads of 64,
G = 1: the cross attention over 1500 frames, warm and on six operand
sets, and the self attention at 96 rows) and hymba-1.5b (25 / 5 heads of
64, 1280 rows, its 1024 window biting), both are held against the plain
version (3e-2, 5e-2 on packed pages) and timed with CUDA events in the
order other, this, this, other.  Where a case has several operand sets
each timed launch reads the next, the sets together past the 50 MB L2.
OTHER's dense slab goes through its ``fd_launch`` with the template's
split plan (``decode_split.plan``); this checkout's through
``flash_decode_cuda``, the route ``route_of`` picks at its own plan.
Prints one line per case and one JSON line.  A card is required; without
one it raises.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.device import resolve
from repro_torch.kernels import _build, decode_split
from repro_torch.kernels.flash_decode import flash_decode as fd_k
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.paged_attention import paged_attention as pa_k
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.serving.kv_pool import quantize_kv

HQ, HKV, HD, BS = 28, 4, 128, 16     # qwen2-7b's heads, head width; block
MAIN_CURS = [35, 41, 33, 46]         # the serve run (prompt 32)
LEVER_CURS = [65, 71, 67, 69]        # the lever runs (prompt 64)
LONG_CURS = [4096, 4101, 4099, 4110]
S_MAIN, S_LONG = 96, 4160            # dense slab lengths
THRESHOLD = 0.25
LONG_SETS = 4
ITERS = 20
# the other dense slabs: (B, S, Hq, Hkv, D, window, cur, operand sets)
DENSE = {"whisper cross": (4, 1500, 8, 8, 64, 0, 1499, 1),
         "whisper cross cold": (4, 1500, 8, 8, 64, 0, 1499, 6),
         "whisper self": (4, 96, 8, 8, 64, 0, [15] * 4, 1),
         "hymba dense": (4, 1280, 25, 5, 64, 1024, [1279, 1100, 500, 1200],
                         LONG_SETS)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _other_libs(root: Path):
    """Compile OTHER's two sources (in parallel); returns {name: (lib,
    split ABI?)}."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("paged_attention", "flash_decode"):
        out = out_dir / f"lib{name}-other.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for OTHER's {name}.cu:\n"
                               f"{stdout}{stderr}")
        lib = ctypes.CDLL(str(out))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        split = re.search(r"void\* ws", (csrc / f"{name}.cu").read_text())
        libs[name] = (lib, split is not None)
    return libs


def _call_other(lib, split_abi, fn, head, ints, q, walk, hkv=HKV):
    """Launch OTHER's ``fn``: ``head`` is the (value, ctype) operands up to
    the output pointer, ``ints`` the int arguments after it.  The split ABI
    adds the workspace after ``head`` and ``splits`` before the stream."""
    f = getattr(lib, fn)
    args = [v for v, _ in head]
    types = [t for _, t in head]
    if split_abi:
        n = decode_split.splits_for(q, hkv, walk, None)
        ws = decode_split.workspace(q, n)
        args.append(None if ws is None else ws.data_ptr())
        types.append(_P)
        ints = ints + [n]
    f.argtypes = types + [_I] * len(ints) + [_P]
    f.restype = ctypes.c_int
    err = f(*args, *ints, _build.stream_of(q))
    _build.check(lib, err, f"other {fn}")


def _tables(curs, dev, gen):
    """Shuffled block chains covering [0, cur] of each slot plus a null
    tail; returns (tables (B, T) int32, pool blocks N)."""
    T = max(-(-(c + 1) // BS) for c in curs) + 1
    N = 1 + len(curs) * T
    free = (torch.randperm(N - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((len(curs), T), dtype=torch.int32)
    for b, c in enumerate(curs):
        for t in range(-(-(c + 1) // BS)):
            tables[b, t] = free.pop()
    return tables.to(dev), N


def _cases(dev, g):
    """{name: (kind, operand sets, tables-or-None, cur, window)}, kind in
    paged / quant / sparse / dense."""
    cpu = torch.Generator().manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def keys(shape, dtype=torch.bfloat16):
        off = torch.randn((shape[0], 1, *shape[2:]), generator=g, device=dev)
        return (torch.randn(shape, generator=g, device=dev) + 2 * off
                ).to(dtype)

    out = {}
    for tag, curs, lever_curs, n_sets in (
            ("main", MAIN_CURS, LEVER_CURS, 1),
            ("long", LONG_CURS, LONG_CURS, LONG_SETS)):
        B = len(curs)
        tables, N = _tables(curs, dev, cpu)
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        out[f"paged_decode {tag}"] = ("paged", [dict(
            q=rnd((B, HQ, HD)), kp=rnd((N, BS, HKV, HD)),
            vp=rnd((N, BS, HKV, HD))) for _ in range(n_sets)], tables, cur,
            0)
        tables, N = _tables(lever_curs, dev, cpu)
        cur = torch.tensor(lever_curs, dtype=torch.int32, device=dev)
        T = tables.shape[1]
        sets = []
        for _ in range(n_sets):
            kq, ks = quantize_kv(keys((N, BS, HKV, HD), torch.float32), "int8")
            vq, vs = quantize_kv(rnd((N, BS, HKV, HD), torch.float32), "int8")
            q = rnd((B, HQ, HD))
            keep = None if tag == "long" else pa_ref.block_keep_mask(
                q, kq, tables, cur, threshold=THRESHOLD, k_scales=ks
            ).to(torch.int32)
            sets.append(dict(q=q, kp=kq, vp=vq, ks=ks, vs=vs, keep=keep,
                             k_row=rnd((B, HKV, HD)), v_row=rnd((B, HKV, HD))))
        out[f"paged_decode_quant {tag}"] = ("quant", sets, tables, cur, 0)
        sets = []
        for _ in range(n_sets):
            q, kp = rnd((B, HQ, HD)), keys((N, BS, HKV, HD))
            if tag == "main":
                keep = pa_ref.block_keep_mask(q, kp, tables, cur,
                                              threshold=THRESHOLD)
            else:       # about half the valid blocks, the current one kept
                valid = pa_ref.valid_blocks(cur, T, BS)[:, None, :]
                current = (torch.arange(T, device=dev)[None, None, :]
                           == (cur[:, None, None] // BS)) & valid
                keep = ((torch.rand((B, HKV, T), generator=g, device=dev)
                         < 0.5) & valid) | current
            sets.append(dict(q=q, kp=kp, vp=rnd((N, BS, HKV, HD)),
                             keep=keep.to(torch.int32)))
        out[f"paged_decode_sparse {tag}"] = ("sparse", sets, tables, cur, 0)
        S = S_MAIN if tag == "main" else S_LONG
        out[f"flash_decode {tag}"] = ("dense", [dict(
            q=rnd((B, HQ, HD)), kp=rnd((B, S, HKV, HD)),
            vp=rnd((B, S, HKV, HD))) for _ in range(n_sets)], None, cur, 0)
    cur = torch.tensor(LEVER_CURS, dtype=torch.int32, device=dev)
    out["flash_decode f32 main"] = ("dense", [dict(
        q=rnd((4, HQ, HD), torch.float32),
        kp=rnd((4, S_MAIN, HKV, HD), torch.float32),
        vp=rnd((4, S_MAIN, HKV, HD), torch.float32))], None, cur, 0)
    for name, (B, S, hq, hkv, D, window, curs, n_sets) in DENSE.items():
        out[f"flash_decode {name}"] = ("dense", [dict(
            q=rnd((B, hq, D)), kp=rnd((B, S, hkv, D)),
            vp=rnd((B, S, hkv, D))) for _ in range(n_sets)], None,
            torch.tensor(curs, dtype=torch.int32, device=dev), window)
    return out


def _runners(kind, sets, tables, cur, window, libs):
    """(run_other(i), run_this(i), plain(i)) for one case."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    def run_other(i):
        s = sets[i]
        q = s["q"]
        o = torch.empty_like(q)
        B, Hq, D = q.shape
        common = [(q.data_ptr(), _P), (s["kp"].data_ptr(), _P),
                  (s["vp"].data_ptr(), _P)]
        dt = _build.dtype_code(q)
        if kind == "dense":
            lib, split = libs["flash_decode"]
            S, hkv = s["kp"].shape[1], s["kp"].shape[2]
            _call_other(lib, split, "fd_launch", common + [
                (cur.data_ptr(), _P), (1 if cur.ndim else 0, _I),
                (o.data_ptr(), _P)], [B, Hq, hkv, D, S, window, dt], q, S,
                hkv)
            return o
        lib, split = libs["paged_attention"]
        T = tables.shape[1]
        ints = [B, Hq, HKV, D, BS, T, 0, dt]
        idx = [(tables.data_ptr(), _P), (cur.data_ptr(), _P)]
        if kind == "paged":
            _call_other(lib, split, "pa_launch", common + idx
                        + [(o.data_ptr(), _P)], ints, q, T * BS)
        elif kind == "sparse":
            _call_other(lib, split, "pa_sparse_launch", common + idx + [
                (s["keep"].data_ptr(), _P), (o.data_ptr(), _P)], ints, q,
                T * BS)
        else:
            _call_other(lib, split, "pa_quant_launch", common + [
                (s["ks"].data_ptr(), _P), (s["vs"].data_ptr(), _P),
                (ptr(s["k_row"]), _P), (ptr(s["v_row"]), _P)] + idx + [
                (ptr(s["keep"]), _P), (o.data_ptr(), _P)],
                ints + [_build.page_code(s["kp"])], q, T * BS)
        return o

    def run_this(i):
        s = sets[i]
        if kind == "dense":
            return fd_k.flash_decode_cuda(s["q"], s["kp"], s["vp"], cur,
                                          window=window)
        if kind == "paged":
            return pa_k.paged_decode_cuda(s["q"], s["kp"], s["vp"], tables,
                                          cur)
        if kind == "sparse":
            return pa_k.paged_decode_sparse_cuda(s["q"], s["kp"], s["vp"],
                                                 tables, cur, s["keep"])
        return pa_k.paged_decode_quant_cuda(
            s["q"], s["kp"], s["vp"], s["ks"], s["vs"], tables, cur,
            k_row=s["k_row"], v_row=s["v_row"], keep=s["keep"])

    def plain(i):
        s = sets[i]
        if kind == "dense":
            return fd_ref.decode_attention(s["q"], s["kp"], s["vp"], cur,
                                           window=window)
        if kind == "paged":
            return pa_ref.paged_decode_attention(s["q"], s["kp"], s["vp"],
                                                 tables, cur)
        if kind == "sparse":
            return pa_ref.paged_decode_attention_sparse(
                s["q"], s["kp"], s["vp"], tables, cur, keep=s["keep"])
        return pa_ref.paged_decode_attention_quant(
            s["q"], s["kp"], s["vp"], s["ks"], s["vs"], tables, cur,
            k_row=s["k_row"], v_row=s["v_row"], keep=s["keep"])

    return run_other, run_this, plain


def _time_ms(fn, n_sets) -> float:
    """Mean device ms of ``fn(i)`` over ITERS launches cycling over the
    operand sets, queued behind a ~10 ms spin so that the events bracket
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
        raise SystemExit("usage: python -m repro_torch.profiling."
                         "decode_attention_ab OTHER_CHECKOUT_ROOT")
    dev = resolve("cuda")
    libs = _other_libs(Path(args[0]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (kind, sets, tables, cur, window) in _cases(dev, g).items():
        run_other, run_this, plain = _runners(kind, sets, tables, cur,
                                              window, libs)
        tol = 5e-2 if kind == "quant" else 3e-2
        want = plain(0).float()
        errs = {}
        for tag, fn in (("other", run_other), ("this", run_this)):
            got = fn(0).float()
            torch.cuda.synchronize()
            errs[tag] = float((got - want).abs().max())
            if not torch.isfinite(got).all() or bool(
                    ((got - want).abs() > tol + tol * want.abs()).any()):
                raise SystemExit(f"{tag} kernel disagrees with the plain "
                                 f"version at {name} (max abs err "
                                 f"{errs[tag]:.3g})")
        n = len(sets)
        turns = [("other", _time_ms(run_other, n)),
                 ("this", _time_ms(run_this, n)),
                 ("this", _time_ms(run_this, n)),
                 ("other", _time_ms(run_other, n))]
        q, kp = sets[0]["q"], sets[0]["kp"]
        r = {tag: [t for k, t in turns if k == tag] for tag in ("other",
                                                               "this")}
        r.update(max_abs_err=errs, contexts=(cur + 1).tolist())
        if kind == "dense":
            S, hkv = kp.shape[1], kp.shape[2]
            route = fd_k.route_of(q, kp, sets[0]["vp"])
            r.update(route=route, splits=dict(
                other=decode_split.splits_for(q, hkv, S, None),
                this=fd_k.tma_plan(q.shape[0], hkv, S, decode_split.sm_count(
                    q.device)) if route == "tma"
                else decode_split.splits_for(q, hkv, S, None)))
        else:
            r.update(splits=decode_split.splits_for(q, HKV, tables.shape[1]
                                                    * BS, None))
        results[name] = r
        route = f", this on {r['route']}" if "route" in r else ""
        print(f"{name} (contexts {r['contexts']}, splits {r['splits']}"
              f"{route}): "
              f"other ms {r['other'][0]:.4f} / {r['other'][1]:.4f}, this ms "
              f"{r['this'][0]:.4f} / {r['this'][1]:.4f}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "other": str(args[0]), "cases": results}), flush=True)


if __name__ == "__main__":
    main()
