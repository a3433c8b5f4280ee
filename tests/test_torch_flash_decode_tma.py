"""Flash decode's Hopper route (``kernels/csrc/flash_decode.cu``:
``fd_tma::kernel``, entry ``fd_tma_launch``), held on the CPU.  The kernel
runs only on a card (``tests/test_torch_flash_decode_tma_card.py``,
``chip_smoke.py``); what it is built from is modelled here:

* its walk, emulated in torch tile by tile in the kernel's order (either
  engine, the tensor cores or the CUDA cores, sums a tile's products in
  its own order inside this algebra): the slice of whole 32-row tiles each
  split takes, the tiles dealt to four consumer warps in turn (warp w the
  tiles t = w mod 4), each warp's own online softmax per query head with
  p rounded to bf16 before p V (l sums the unrounded p), the warps' states
  merged in warp order, the splits' in split order; held against the
  port's plain version and the JAX package's reference (and its Pallas
  kernel in interpret mode) at whisper's cross and self shapes, hymba's
  window, qwen2-7b's dense slabs and the edges;
* the TMA box on the (D, Hkv, S, B) view of a (B, S, Hkv, D) cache (zeros
  past S and D, the right slot and head) placed by the 128-byte swizzle,
  and the consumers' reads of K (a lane a row) and V (a lane 8 columns of
  a row a step) at their swizzled places: they read back what TMA wrote;
* the route's split plan: shapes alone, a power of two within the
  cluster's 8 and the walk's tiles, slices covering the walk once; the
  engine the launch picks by group size;
* the route function at every reference config's dense-decode shape and
  the edges that stay on the template.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.flash_decode import ref as jfd_ref
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build, decode_split
from repro_torch.kernels.flash_decode import flash_decode as fd_k
from repro_torch.kernels.flash_decode import ref as fd_ref

NEG = -1e30
ROWS = 32                    # a tile: one row a lane
WARPS = 4                    # consumer warps a CTA
LINE = 128                   # bytes a swizzle line (64 bf16)
BOX = ROWS * LINE            # a TMA box: 32 lines
H100_SMS = 132
TOL = 3e-2


# ---------------------------------------------------------------------------
# the kernel's walk, emulated
# ---------------------------------------------------------------------------


def emulate(q, k, v, cur, window=0, splits=None):
    """``fd_tma::kernel`` (its cluster's merge of the splits) on the CPU.  q
    (B, Hq, D), k / v (B, S, Hkv, D) bf16, cur () or (B,) int.  ``splits``:
    default ``tma_plan`` at an H100's 132 SMs."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    if splits is None:
        splits = fd_k.tma_plan(B, Hkv, S, H100_SMS)
    curs = np.broadcast_to(np.asarray(cur), (B,))
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    for b in range(B):
        c = int(curs[b])
        last = min(c, S - 1)
        lo = max(0, c - window + 1) if window > 0 else 0
        n = max(0, last - lo + 1)
        per = -(-(-(-n // ROWS)) // splits)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            states = []
            for z in range(splits):
                i_lo = min(n, z * per * ROWS)
                i_hi = min(n, (z + 1) * per * ROWS)
                n_t = -(-(i_hi - i_lo) // ROWS)
                warps = []
                for w in range(WARPS):
                    m = torch.full((G,), NEG)
                    l = torch.zeros(G)
                    acc = torch.zeros(G, D)
                    for t in range(w, n_t, WARPS):
                        i = i_lo + t * ROWS + torch.arange(ROWS)
                        exists = i < i_hi
                        p = lo + i
                        inside = p < S             # TMA's zeros past S
                        rows = torch.where(inside, p, torch.zeros_like(p))
                        K = k[b, rows, h].float() * inside[:, None]
                        V = v[b, rows, h].float() * inside[:, None]
                        sc = (qg @ K.T) * scale
                        ok = exists & ((window <= 0) | (p > c - window))
                        sc = torch.where(ok, sc, torch.tensor(NEG))
                        m_new = torch.maximum(m, torch.where(
                            exists, sc, torch.tensor(-math.inf)).amax(-1))
                        pe = torch.where(exists,
                                         torch.exp(sc - m_new[:, None]),
                                         torch.tensor(0.0))
                        corr = torch.exp(m - m_new)
                        l = l * corr + pe.sum(-1)
                        acc = acc * corr[:, None] \
                            + pe.to(torch.bfloat16).float() @ V
                        m = m_new
                    warps.append((m, l, acc))
                states.append(_merge(warps))      # the warps, in order
            M, den, num = states[0] if splits == 1 else _merge(states)
            out[b, h * G:(h + 1) * G] = (
                num / torch.clamp(den, min=1e-30)[:, None]).to(q.dtype)
    return out


def _merge(states):
    """(max m, sum exp(m_i - M) l_i, sum exp(m_i - M) acc_i), in order."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    num, den = 0.0, 0.0
    for m, l, acc in states:
        c = torch.exp(m - M)
        num = num + c[:, None] * acc
        den = den + c * l
    return M, den, num


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    return q, k, v


def _bf(x):
    return to_torch(x, "cpu", torch.bfloat16)


def _check(got, want):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


# (B, S, Hq, Hkv, D, window, cur): the main path's shapes at their widths
# (fewer slots or rows where the walk is long) and the edges
SHAPES = {
    "whisper cross": (2, 1500, 8, 8, 64, 0, 1499),
    "whisper self": (4, 48, 8, 8, 64, 0, [15, 20, 3, 40]),
    "hymba window": (2, 1280, 25, 5, 64, 1024, [1279, 1100]),
    "qwen2-7b serving": (4, 96, 28, 4, 128, 0, [65, 71, 67, 69]),
    "qwen2-7b 4096": (1, 4160, 28, 4, 128, 0, [4100]),
    "cur 0 / 31 / 32 / 33": (4, 40, 8, 2, 64, 0, [0, 31, 32, 33]),
    "cur 63 / 64 / 65": (3, 70, 4, 4, 128, 0, [63, 64, 65]),
    "ragged S, scalar cur": (2, 77, 4, 2, 64, 0, 76),
    "window mid-tile": (3, 90, 8, 2, 64, 20, [89, 50, 5]),
    "cur past S": (2, 33, 6, 2, 16, 0, [40, 32]),
    "D=80, G=3": (2, 100, 6, 2, 80, 0, [99, 40]),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulated_walk_matches_the_plain_version(name):
    B, S, Hq, Hkv, D, window, cur = SHAPES[name]
    q, k, v = (_bf(x) for x in _inputs(len(name), B, S, Hq, Hkv, D))
    tc = torch.tensor(cur, dtype=torch.int32)
    want = fd_ref.decode_attention(q, k, v, tc, window=window)
    _check(emulate(q, k, v, cur, window), want)
    if tc.ndim == 0:                   # the JAX oracle takes a scalar
        jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                      for x in (q, k, v))
        _check(emulate(q, k, v, cur, window), jfd_ref.decode_attention(
            jq, jk, jv, jnp.asarray(cur, jnp.int32), window=window))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_forced_splits_and_empty_slices(splits):
    """Any count a cluster takes gives the same function; the per-slot
    walks differ in length (1, 3 and 7 tiles), so where the splits
    outnumber a walk's tiles the last slices are empty: m = -1e30, l = 0
    and no weight in the merge."""
    B, S, Hq, Hkv, D = 3, 200, 8, 2, 64
    q, k, v = (_bf(x) for x in _inputs(splits, B, S, Hq, Hkv, D))
    cur = [199, 0, 64]
    want = fd_ref.decode_attention(q, k, v, torch.tensor(cur,
                                                         dtype=torch.int32))
    _check(emulate(q, k, v, cur, splits=splits), want)


def test_emulated_walk_matches_the_pallas_kernel():
    """One small shape against the JAX package's Pallas kernel in
    interpret mode (scalar cur, a window)."""
    B, S, Hq, Hkv, D, cur, window = 2, 192, 8, 2, 64, 150, 100
    q, k, v = _inputs(3, B, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jfd_ops.flash_decode(jq, jk, jv, jnp.asarray(cur, jnp.int32),
                                window=window, bk=64, interpret=True)
    _check(emulate(_bf(q), _bf(k), _bf(v), cur, window), want)


def test_each_warp_takes_every_fourth_tile():
    """The warps' share: a slice of 10 tiles gives warps 0-1 three tiles
    and warps 2-3 two, and a warp without a tile leaves a state that
    weighs nothing (m = -1e30, l = 0)."""
    deals = [list(range(w, 10, WARPS)) for w in range(WARPS)]
    assert deals == [[0, 4, 8], [1, 5, 9], [2, 6], [3, 7]]
    G, D = 2, 8
    real = (torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]),
            torch.ones(G, D))
    idle = (torch.full((G,), NEG), torch.zeros(G), torch.zeros(G, D))
    M, den, num = _merge([idle, real, idle, idle])
    assert torch.equal(M, real[0]) and torch.equal(den, real[1])
    assert torch.equal(num, real[2])


# ---------------------------------------------------------------------------
# the TMA box and the consumers' reads
# ---------------------------------------------------------------------------


def swizzle(addr):
    """The 128-byte swizzle TMA writes: the 16-byte chunk within a line XOR
    the line within 8 (from a 1024-aligned base)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def box(t, c0, h, r0, b):
    """The box at (c0, h, r0, b) of the (D, Hkv, S, B) view of t (B, S,
    Hkv, D): rows r0 .. r0 + 31 by columns c0 .. c0 + 63 of head h of slot
    b, zeros past S and D."""
    B, S, H, D = t.shape
    out = np.zeros((ROWS, 64))
    if r0 < S and c0 < D:
        rows, cols = min(ROWS, S - r0), min(64, D - c0)
        out[:rows, :cols] = t[b, r0:r0 + rows, h, c0:c0 + cols]
    return out


def stage_image(t, h, r0, b, DC):
    """Shared memory (one slot a bf16) after the producer's DC boxes of one
    tile land at 4 KB apart, each placed by the swizzle."""
    img = np.full(DC * BOX // 2, np.nan)
    r, i = np.meshgrid(np.arange(ROWS), np.arange(64), indexing="ij")
    for c in range(DC):
        img[(c * BOX + swizzle(r * LINE + 2 * i)) // 2] = box(t, 64 * c, h,
                                                              r0, b)
    return img


def k_chunk(img, lane, c):
    """The 8 values lane ``lane`` reads as chunk c of its K row."""
    at = (c // 8) * BOX + lane * LINE + (((c % 8) ^ (lane & 7)) << 4)
    return img[at // 2:at // 2 + 8]


def v_chunk(img, lane, j, DC):
    """The 8 values lane ``lane`` reads at p V step j: row j * RPS + lane /
    (8 DC), chunk lane % (8 DC)."""
    cpr = 8 * DC
    r, ch = j * (32 // cpr) + lane // cpr, lane % cpr
    at = (ch // 8) * BOX + r * LINE + (((ch % 8) ^ (r & 7)) << 4)
    return r, ch, img[at // 2:at // 2 + 8]


@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_consumers_read_what_tma_wrote(D):
    """Distinct values: K row ``lane`` chunk c and V row r chunk ch, read at
    their swizzled places, are the cache's own (zeros past S and D), for
    the slot and head the box names."""
    DC = -(-D // 64)
    B, S, H = 2, 70, 3
    t = np.random.default_rng(D).permutation(B * S * H * D).reshape(
        B, S, H, D) + 1.0
    b, h, r0 = 1, 2, 64                        # a tile crossing S = 70
    pad = np.zeros((ROWS, 64 * DC))
    pad[:S - r0, :D] = t[b, r0:S, h]
    img = stage_image(t, h, r0, b, DC)
    for lane in range(32):
        for c in range(8 * DC):
            np.testing.assert_array_equal(k_chunk(img, lane, c),
                                          pad[lane, 8 * c:8 * c + 8])
    seen = np.zeros((ROWS, 8 * DC), int)
    for j in range(ROWS // (32 // (8 * DC))):
        for lane in range(32):
            r, ch, got = v_chunk(img, lane, j, DC)
            np.testing.assert_array_equal(got, pad[r, 8 * ch:8 * ch + 8])
            seen[r, ch] += 1
    assert (seen == 1).all()                   # every chunk read once a tile


def test_reads_are_bank_conflict_free():
    """Each quarter warp's 16-byte reads (8 lanes) fall on 8 distinct
    16-byte bank groups: K (a lane a row, the same logical chunk) and V (a
    quarter warp one line)."""
    for DC in (1, 2):
        for c in range(8 * DC):
            for q0 in range(0, 32, 8):
                at = [(c // 8) * BOX + ln * LINE + (((c % 8) ^ (ln & 7)) << 4)
                      for ln in range(q0, q0 + 8)]
                assert len({(a // 16) % 8 for a in at}) == 8
        cpr = 8 * DC
        for j in range(ROWS // (32 // cpr)):
            for q0 in range(0, 32, 8):
                at = []
                for ln in range(q0, q0 + 8):
                    r, ch = j * (32 // cpr) + ln // cpr, ln % cpr
                    at.append((ch // 8) * BOX + r * LINE
                              + (((ch % 8) ^ (r & 7)) << 4))
                assert len({(a // 16) % 8 for a in at}) == 8


def test_boxes_fill_zeros_and_pick_slot_and_head():
    t = np.arange(2 * 70 * 3 * 72, dtype=float).reshape(2, 70, 3, 72) + 1
    got = box(t, 64, 1, 60, 1)
    assert (got[:10, :8] == t[1, 60:70, 1, 64:72]).all()
    assert (got[10:] == 0).all() and (got[:, 8:] == 0).all()
    assert (box(t, 0, 0, 70, 0) == 0).all()
    assert (box(t, 0, 2, 0, 0)[:, :64] == t[0, :32, 2, :64]).all()


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------


def test_plan_is_a_function_of_shapes_alone():
    assert list(inspect.signature(fd_k.tma_plan).parameters) == [
        "B", "Hkv", "walk", "sm_count"]
    for B, Hkv in ((1, 1), (4, 4), (4, 8), (4, 20), (64, 8)):
        for walk in (1, 31, 32, 33, 96, 1500, 4160, 65536):
            n = fd_k.tma_plan(B, Hkv, walk, H100_SMS)
            tiles = -(-walk // ROWS)
            assert n == fd_k.tma_plan(B, Hkv, walk, H100_SMS)
            assert n & (n - 1) == 0 and 1 <= n <= fd_k.TMA_MAX_SPLITS
            # every CTA keeps a tile a consumer warp
            assert n == 1 or tiles >= n * fd_k.TMA_MIN_TILES
            # doubled until the cap, the tiles or the SMs stop it
            more = 2 * n
            assert (more > fd_k.TMA_MAX_SPLITS
                    or tiles < more * fd_k.TMA_MIN_TILES
                    or B * Hkv * n >= fd_k.TMA_WAVES * H100_SMS)


def test_plan_at_the_main_paths_shapes():
    assert fd_k.tma_plan(4, 8, 1500, H100_SMS) == 8      # whisper cross
    assert fd_k.tma_plan(4, 8, 96, H100_SMS) == 1        # whisper self
    assert fd_k.tma_plan(4, 5, 1280, H100_SMS) == 8      # hymba, 1280 rows
    assert fd_k.tma_plan(4, 4, 96, H100_SMS) == 1        # qwen2-7b serving
    assert fd_k.tma_plan(4, 4, 4160, H100_SMS) == 8      # qwen2-7b 4,096
    assert fd_k.tma_plan(4, 20, 4160, H100_SMS) == 4     # qwen1.5-4b
    assert fd_k.tma_plan(64, 8, 4160, H100_SMS) == 1     # many slots


def test_engine_by_group_size():
    """The launch picks the engine from G alone: the CUDA cores (a CTA
    keeping one head's state) at G = 1 (whisper, qwen1.5-4b), the tensor
    cores (16 heads' rows) from G = 2 up to the route's 16; the C entry
    takes no engine argument."""
    src = (_build.CSRC / "flash_decode.cu").read_text()
    assert "return G == 1 ? run<DC, 1>(tk, tv, a, s) : " \
        "run<DC, MAX_GROUP>(tk, tv, a, s);" in src
    assert "if constexpr (GM == 1) {\n    consume_cores<DC>(" in src
    assert "constexpr int MAX_GROUP = 16;" in src
    assert fd_k.TMA_MAX_GROUP == 16
    assert len(fd_k.SIGNATURES["fd_tma_launch"]) == 14
    assert "mma" not in inspect.signature(fd_k.flash_decode_cuda).parameters


@pytest.mark.parametrize("n", [1, 31, 32, 33, 95, 1500])
def test_slices_cover_the_walk_once(n):
    """The kernel's slices (``decode_split.split_slice``: the same 32-row
    tiles) of a walk of n rows, at every count the route takes."""
    for splits in (1, 2, 4, 8, 3, 40):
        seen = []
        for z in range(splits):
            lo, hi = decode_split.split_slice(n, splits, z)
            assert lo % ROWS == 0 or lo == hi == n
            seen.extend(range(lo, hi))
        assert seen == list(range(n))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("whisper_base", "hymba_1p5b", "qwen2_7b", "qwen1p5_4b",
               "mistral_nemo_12b", "qwen3_moe_30b_a3b", "internvl2_26b",
               "qwen1p5_110b", "dbrx_132b")


def _operands(B, S, Hq, Hkv, D, dtype=torch.bfloat16, offset=0):
    q = torch.zeros((B, Hq, D), dtype=dtype)
    flat = torch.zeros(B * S * Hkv * D + offset, dtype=dtype)
    k = flat[offset:].view(B, S, Hkv, D)
    return q, k, k


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_every_reference_configs_dense_decode_takes_tma(arch):
    cfg = get_config(arch)
    q, k, v = _operands(4, 96, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    assert fd_k.route_of(q, k, v) == "tma"
    q, k, v = _operands(4, 96, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        dtype=torch.float32)
    assert fd_k.route_of(q, k, v) == "template"


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((2, 30, 4, 2, 16), torch.bfloat16, 0, "tma"),        # D = 16
    ((2, 30, 4, 2, 20), torch.bfloat16, 0, "template"),   # a 40-byte row
    ((2, 30, 4, 2, 64), torch.float32, 0, "template"),
    ((2, 30, 34, 2, 64), torch.bfloat16, 0, "template"),  # G = 17
    ((2, 30, 16, 1, 64), torch.bfloat16, 0, "tma"),       # G = 16
    ((2, 30, 4, 2, 64), torch.bfloat16, 4, "template"),   # off 16 bytes
    ((2, 30, 4, 2, 136), torch.bfloat16, 0, "template"),  # D > 128
])
def test_route_edges(shape, dtype, offset, want):
    assert fd_k.route_of(*_operands(*shape, dtype=dtype, offset=offset)) \
        == want
