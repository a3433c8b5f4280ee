"""A numpy model of what flash attention's warpgroup kernels
(``kernels/csrc/flash_attention.cu``'s ``fa_wgmma_kernel``,
``kernels/csrc/flash_attention_bwd.cu``'s ``*_wgmma`` kernels) read: the
TMA boxes (64 columns x 1 head x 64 rows x 1 batch of the (D, H, S, B) view
of a (B, S, H, D) tensor, zeros past S and D) placed in shared memory by
the 128-byte swizzle, and the slices each ``wgmma`` descriptor reads back
through the same swizzle, K-major or MN-major (the transpose bit); the
visibility of a (query, key) pair and of a 64 x 64 tile
(``csrc/attention_tma.cuh``); the order in which an SM that frees takes
the next CTA of a one-dimensional grid; and the conv2d kernel's
(``kernels/csrc/conv2d.cu``'s ``conv_wgmma``) TMA im2col walk and the
128-byte lines it places.
"""
import heapq

import numpy as np

LINE = 128                   # bytes a swizzle line (64 bf16)
BOX = 64 * LINE              # a TMA box: 64 lines
PIXELS = 128                 # an im2col load's pixels: conv_wgmma's rows
H100_SMS = 132


def swizzle(addr):
    """The 128-byte swizzle TMA writes and wgmma reads: the 16-byte chunk
    within a line XOR the line within 8 (addresses from a 1024-aligned
    base)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def box(t, c0, h, r0, b):
    """The TMA box at (c0, h, r0, b) of the (D, H, S, B) view of t (B, S,
    H, D): rows r0 .. r0 + 63 by columns c0 .. c0 + 63 of head h, zeros past
    S and D."""
    B, S, H, D = t.shape
    out = np.zeros((64, 64))
    if r0 < S and c0 < D:
        rows, cols = min(64, S - r0), min(64, D - c0)
        out[:rows, :cols] = t[b, r0:r0 + rows, h, c0:c0 + cols]
    return out


def place(img, at, val):
    """Write a 64 x 64 box at byte ``at`` (a multiple of 1024) of a shared
    memory image (one slot a bf16), swizzled as TMA writes it."""
    r, i = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    img[(at + swizzle(r * LINE + 2 * i)) // 2] = val


def tile(t, DC, h, r0, b, halves=1):
    """A tile as the kernels' producer loads it: ``halves`` x 64 rows from
    r0, each DC boxes of 64 columns, box (w, c) at (w DC + c) BOX."""
    img = np.full(halves * DC * BOX // 2, np.nan)
    for w in range(halves):
        for c in range(DC):
            place(img, (w * DC + c) * BOX, box(t, 64 * c, h, r0 + 64 * w, b))
    assert not np.isnan(img).any()
    return img


def kmajor(img, start, rows=64):
    """The (rows, 16) K slice a K-major descriptor at byte ``start`` reads
    (SBO 1024: 8 lines of 128 bytes)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return img[swizzle(start + (r // 8) * 1024 + (r % 8) * LINE + 2 * k) // 2]


def mnmajor(img, start, n, lbo=BOX):
    """The (n, 16) slice an MN-major B descriptor at byte ``start`` reads
    (LBO: the stride of 64-column atoms along N; SBO 1024)."""
    r, k = np.meshgrid(np.arange(n), np.arange(16), indexing="ij")
    addr = (start + (r // 64) * lbo + (k // 8) * 1024 + (k % 8) * LINE
            + (r % 64) * 2)
    return img[swizzle(addr) // 2]


def ss(a_img, a0, b_img, b0, DC):
    """A B^T (64 x 64) over 64 DC columns, both operands K-major: slice
    (c, kk) at c BOX + 32 kk (the forward's S = Q K^T, the backward's
    two_abt)."""
    out = np.zeros((64, 64))
    for c in range(DC):
        for kk in range(4):
            off = c * BOX + kk * 32
            out += kmajor(a_img, a0 + off) @ kmajor(b_img, b0 + off).T
    return out


def rs(frag, b_img, DC, lbo=BOX):
    """frag (64 x K, registers) @ B (K lines x 64 DC, MN-major, the column
    atoms ``lbo`` bytes apart), slice kk 16 lines (2048 bytes) on (the
    forward's O += P V, the backward's acc_hi_lo)."""
    out = np.zeros((64, 64 * DC))
    for kk in range(frag.shape[1] // 16):
        out += frag[:, 16 * kk:16 * kk + 16] @ mnmajor(b_img, kk * 2048,
                                                       64 * DC, lbo).T
    return out


def visible(qi, kj, Sq, Skv, window, causal):
    ok = (qi < Sq) & (kj < Skv)
    if causal:
        ok &= qi >= kj
    if window > 0:
        ok &= qi - kj < window
    return ok


def tile_any(r0, k0, Sq, Skv, window, causal, nk=64):
    """Some (query, key) of rows [r0, r0 + 64) x keys [k0, k0 + nk)
    visible."""
    if r0 >= Sq or k0 >= Skv:
        return False
    r1, k1 = min(r0 + 63, Sq - 1), min(k0 + nk - 1, Skv - 1)
    return (not causal or r1 >= k0) and (window <= 0 or r0 - k1 < window)


def tile_full(q0, k0, Sq, Skv, window, causal, nk=64):
    """Every (query, key) of rows [q0, q0 + 64) x keys [k0, k0 + nk)
    visible."""
    return (q0 + 64 <= Sq and k0 + nk <= Skv
            and (not causal or q0 >= k0 + nk - 1)
            and (window <= 0 or q0 + 63 - k0 < window))


def dc_of(D):
    return 1 if D <= 64 else 2


def makespan(jobs, sms=H100_SMS):
    """Blocks taken in launch order, each by the SM that frees first (one
    CTA an SM): the time the last one ends."""
    free = [0.0] * sms
    for j in jobs:
        heapq.heappush(free, heapq.heappop(free) + j)
    return max(free)


def walk(N, Hp, Wp, kh, kw, s, m0, n_pix=PIXELS):
    """TMA's im2col walk from output pixel m0: each pixel's (n, h, w)
    window corner, n = N and past for the zero rows."""
    Ho, Wo = (Hp - kh) // s + 1, (Wp - kw) // s + 1
    n, rem = divmod(m0, Ho * Wo)
    h, w = (rem // Wo) * s, (rem % Wo) * s
    out = []
    for _ in range(n_pix):
        out.append((n, h, w))
        w += s
        if w > Wp - kw:             # the bounding box's far column
            w, h = 0, h + s
            if h > Hp - kh:
                h, n = 0, n + 1
    return out


def im2col(xp, kh, kw, s, m0, c, i, j, ch):
    """The (128, ch) box of one load: tap (i, j), channels [c, c + ch)."""
    N, Hp, Wp, _ = xp.shape
    box = np.zeros((PIXELS, ch), xp.dtype)
    for p, (n, h, w) in enumerate(walk(N, Hp, Wp, kh, kw, s, m0)):
        if n < N:
            box[p] = xp[n, h + i, w + j, c:c + ch]
    return box


def place_lines(box, esize):
    """A box of 128-byte lines as TMA writes it to shared memory (128-byte
    swizzle): a flat image of esize-byte slots."""
    rows, per = box.shape
    img = np.full(rows * LINE // esize, np.nan)
    r, e = np.meshgrid(np.arange(rows), np.arange(per), indexing="ij")
    img[swizzle(r * LINE + e * esize) // esize] = box
    return img
