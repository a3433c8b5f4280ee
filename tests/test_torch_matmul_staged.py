"""How the tensor-core matmul stages an operand whose rows are not 16-byte
aligned, modelled on the CPU: the kernel, ``mm_mma`` in
``kernels/csrc/matmul.cu``, runs only on a card, where ``chip_smoke.py
--only matmul`` holds it; its address arithmetic (``Skew``,
``windows_of``, ``realign``, ``skew_load`` / ``skew_store``) is repeated
below and held here:

* a staged tile equals plain slicing of the operand, zeros outside it, at
  every view offset of 0-14 bytes, every row pitch mod 8, tiles on the
  last rows of the buffer, past the operand's columns and at a split's
  end; every window read lies in the operand's 16-byte-aligned span and
  holds an element of a row the tile reads;
* the chunk split mirrors the kernel's constants;
* one emulated launch (every tile, K step and split) at small misaligned
  shapes against the JAX package's ``ref.matmul`` and the port's plain
  version at the reference's bf16 tolerance (3e-2), and, where only the
  views are off, bit for bit the aligned launch on the same values.

Memory is a flat array of bf16 values whose element 0 lies on a 16-byte
boundary, so window w, the aligned 16 bytes the kernel reads as one
vector, is elements [8 w, 8 w + 8).  An operand is a row-major matrix of
``ld`` elements a row from element ``off``.
"""
from typing import List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import ref as jmm_ref
from repro_torch.kernels.matmul import plan as P
from repro_torch.kernels.matmul import ref as mm_ref

WINDOW = 8          # bf16 elements in an aligned 16-byte window
THREADS = 128       # a CTA of mm_mma


class Row(NamedTuple):
    """One tile row of a staged operand (``Windows`` in the kernel)."""
    base: int       # the window that holds the row's first element
    shift: int      # the elements of that window before it (0-7)
    valid: int      # how many of the row's elements lie in the operand

    def holds(self, j: int) -> bool:
        """Whether window base + j holds an element of the row: only
        those are read."""
        return self.valid > 0 and WINDOW * j < self.shift + self.valid


def tile_row(off, row, ld, col, limit, row_ok, n) -> Row:
    """Elements [col, col + n) of ``row``; columns from ``limit`` on, and
    the whole row when not ``row_ok``, lie outside the operand."""
    at = off + row * ld + col
    return Row(at // WINDOW, at % WINDOW,
               max(0, min(n, limit - col)) if row_ok else 0)


def realign(lo, hi, shift, valid) -> np.ndarray:
    """The 8 elements from element ``shift`` of ``lo`` on (the rest from
    ``hi``), those from ``valid`` on zeroed."""
    out = np.concatenate([lo, hi])[shift:shift + WINDOW].copy()
    out[max(0, valid):] = 0
    return out


def chunks(rows: int, rc: int) -> Tuple[int, int]:
    """(CPT, TPR): the consecutive chunks a thread owns in a tile of
    ``rows`` rows of ``rc`` 8-element chunks, and the threads a row."""
    cpt = rows * rc // THREADS
    tpr = rc // max(cpt, 1)
    if cpt < 1 or rc % cpt or rows * tpr != THREADS:
        raise ValueError(f"skew: no chunk split of {rows} x {rc}")
    return cpt, tpr


def stage(mem, off, ld, row0, rows, col0, rc, row_limit,
          col_limit) -> Tuple[np.ndarray, List[int]]:
    """The tile of rows [row0, row0 + rows) and columns [col0, col0 + 8
    rc) as ``mm_mma`` stages it, rows from ``row_limit`` and columns from
    ``col_limit`` on zero; and the windows it read, in order."""
    cpt, tpr = chunks(rows, rc)
    tile = np.zeros((rows, rc * WINDOW), mem.dtype)
    reads: List[int] = []
    zero = np.zeros(WINDOW, mem.dtype)

    def window(row: Row, j: int) -> np.ndarray:
        if not row.holds(j):
            return zero
        w = row.base + j
        reads.append(w)
        got = mem[w * WINDOW:(w + 1) * WINDOW]
        if len(got) != WINDOW:
            raise IndexError(f"skew: window {w} past the buffer")
        return got

    for tid in range(THREADS):
        r, c0 = tid // tpr, (tid % tpr) * cpt
        row = tile_row(off, row0 + r, ld, col0, col_limit,
                       row0 + r < row_limit, rc * WINDOW)
        win = [window(row, c0 + j) for j in range(cpt + 1)]   # skew_load
        for i in range(cpt):                                   # skew_store
            c = (c0 + i) * WINDOW
            tile[r, c:c + WINDOW] = realign(win[i], win[i + 1], row.shift,
                                            row.valid - c)
    return tile, reads


def _aligned_tile(mem, off, ld, row0, rows, col0, cols, row_limit,
                  col_limit):
    """An aligned operand's tile as cp.async stages it: 16-byte chunks
    wholly in (read) or wholly out (zeros)."""
    tile = np.zeros((rows, cols), mem.dtype)
    for r in range(min(rows, row_limit - row0)):
        for c in range(0, min(cols, col_limit - col0), WINDOW):
            at = off + (row0 + r) * ld + col0 + c
            tile[r, c:c + WINDOW] = mem[at:at + WINDOW]
    return tile


def product(a_mem, a_off, b_mem, b_off, M, K, N, p: P.Plan) -> np.ndarray:
    """What ``mm_mma`` computes for A (M, K) at ``a_off`` of ``a_mem`` and
    B (K, N) at ``b_off`` of ``b_mem`` (bf16 values held as f32) by plan
    ``p``: each CTA tile's K steps staged (``stage`` for a staged operand,
    16-byte chunks for an aligned one), f32 products in K steps of 16, the
    splits' partial sums added in split order, rounded once to bf16.
    Returns (M, N) f32 holding bf16 values."""
    assert p.route == "mma", p
    bm, bk, bn = p.bm, P.MMA_BK[p.bm], P.MMA_BN
    total = np.zeros((M, N), np.float32)
    for lo, hi in p.ranges(K):
        part = np.zeros((M, N), np.float32)
        for m0 in range(0, M, bm):
            for n0 in range(0, N, bn):
                acc = np.zeros((bm, bn), np.float32)
                for k0 in range(lo, hi, bk):
                    if p.staged[0]:
                        at, _ = stage(a_mem, a_off, K, m0, bm, k0, bk // 8,
                                      M, hi)
                    else:
                        at = _aligned_tile(a_mem, a_off, K, m0, bm, k0, bk,
                                           M, hi)
                    if p.staged[1]:
                        bt, _ = stage(b_mem, b_off, N, k0, bk, n0, bn // 8,
                                      hi, N)
                    else:
                        bt = _aligned_tile(b_mem, b_off, N, k0, bk, n0, bn,
                                           hi, N)
                    for kk in range(0, bk, 16):
                        acc += at[:, kk:kk + 16] @ bt[kk:kk + 16]
                part[m0:m0 + bm, n0:n0 + bn] = acc[:M - m0, :N - n0]
        total += part
    return torch.from_numpy(total).to(torch.bfloat16).float().numpy()


H100_SMS = 132
# a staged tile: (rows, 8-element chunks a row) of A at each row tile, B's
TILES = {"A16": (16, 8), "A64": (64, 8), "A128": (128, 8), "B": (64, 16)}
PITCHES = (1, 7, 9, 10, 11, 12, 13, 14, 15, 68, 130, 515, 1003)


def _plain(mem, off, ld, row0, rows, col0, cols, row_limit, col_limit):
    r = np.arange(row0, row0 + rows)[:, None]
    c = np.arange(col0, col0 + cols)[None, :]
    inside = (r < row_limit) & (c < col_limit)
    return np.where(inside, mem[np.where(inside, off + r * ld + c, 0)], 0)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("off", range(8))        # elements: 0-14 bytes
def test_staged_tile_is_plain_slicing(tile, off):
    rows, rc = TILES[tile]
    cols = 8 * rc
    for ld in PITCHES:
        n_rows = rows + 3
        size = off + n_rows * ld
        # the buffer ends where the operand does, rounded to a window
        mem = np.arange(1, -(-size // 8) * 8 + 1, dtype=np.float32)
        mem[:off] = -1.0
        mem[size:] = -2.0
        span = (off // 8, -(-size // 8))           # aligned windows
        for row0, col0, row_limit, col_limit in (
                (0, 0, n_rows, ld),                 # the first tile
                (3, 0, n_rows, ld),                 # the buffer's last rows
                (2, max(0, ld - 5), n_rows, ld),    # past the last column
                (1, 0, 1 + rows // 2, min(ld, 9)),  # a split's end
                (n_rows, 0, n_rows, ld)):           # wholly outside
            got, reads = stage(mem, off, ld, row0, rows, col0, rc,
                               row_limit, col_limit)
            want = _plain(mem, off, ld, row0, rows, col0, cols, row_limit,
                          col_limit)
            np.testing.assert_array_equal(got, want, err_msg=str(
                (ld, row0, col0, row_limit, col_limit)))
            w = np.asarray(reads, dtype=np.int64)
            assert ((span[0] <= w) & (w < span[1])).all()
            # each window holds an element of a row the tile reads
            elems = 8 * w[:, None] + np.arange(8)[None, :] - off
            r, c = elems // ld, elems % ld
            inside = (elems >= 0) & (r >= row0) & (r < min(
                row0 + rows, row_limit)) & (c >= col0) & (c < min(
                    col0 + cols, col_limit))
            assert inside.any(axis=1).all(), (ld, row0, col0)


@pytest.mark.parametrize("shift", range(8))
def test_realign_shifts_and_zeroes_lanes(shift):
    lo = np.arange(8, dtype=np.float32)
    hi = np.arange(8, 16, dtype=np.float32)
    for valid in range(-1, 10):
        want = np.arange(shift, shift + 8, dtype=np.float32)
        want[max(0, valid):] = 0
        np.testing.assert_array_equal(realign(lo, hi, shift, valid), want)


def test_chunk_split_mirrors_the_kernel():
    """``Skew<ROWS, RC, 128>`` in csrc/matmul.cu: A at each row tile (8
    chunks a 64-row K step), B (16 chunks a 128-column tile)."""
    assert {bm: chunks(bm, P.MMA_BK[bm] // 8) for bm in P.MMA_BMS} == {
        16: (1, 8), 64: (4, 2), 128: (8, 1)}
    assert chunks(64, P.MMA_BN // 8) == (8, 2)
    with pytest.raises(ValueError, match="chunk split"):
        chunks(8, 8)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _operand(rng, rows, ld, off, scale=1.0):
    """A bf16-valued operand ``off`` elements into a buffer, with garbage
    (NaN) around it that a staged launch must never pick up."""
    x = _bf16(rng.standard_normal((rows, ld)).astype(np.float32) * scale)
    mem = np.full(-(-(off + x.size) // 8) * 8 + 8, np.nan, np.float32)
    mem[off:off + x.size] = x.ravel()
    return x, mem


@pytest.mark.parametrize("M,K,N,a_off,b_off,splits", [
    (37, 1003, 517, 0, 0, None),     # K and N odd: both staged, 3 splits
    (37, 1003, 517, 3, 5, 2),
    (20, 200, 37, 0, 7, None),       # B alone staged
    (70, 130, 64, 1, 0, 1),          # A alone (off by 2 bytes)
    (33, 136, 200, 3, 1, None),      # 16-byte rows, both views off
    (33, 136, 200, 0, 5, 2),         # B's view off alone
])
def test_emulated_launch_vs_jax_ref(M, K, N, a_off, b_off, splits):
    rng = np.random.default_rng(M * N + K)
    a, a_mem = _operand(rng, M, K, a_off)
    b, b_mem = _operand(rng, K, N, b_off, 1 / np.sqrt(K))
    p = P.plan(M, N, K, bf16=True, n_sm=H100_SMS, splits=splits,
               is_aligned=P.aligned(N, K, 2 * a_off, 2 * b_off))
    assert p.route == "mma" and any(p.staged)
    got = product(a_mem, a_off, b_mem, b_off, M, K, N, p)
    assert np.isfinite(got).all()
    tol = dict(rtol=3e-2, atol=3e-2)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    np.testing.assert_allclose(got, np.asarray(jmm_ref.matmul(ja, jb),
                                               np.float32), **tol)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    np.testing.assert_allclose(got, mm_ref.matmul(ta, tb).float().numpy(),
                               **tol)
    if K % 8 == 0 and N % 8 == 0:    # the bits of the aligned launch
        a_at = np.concatenate([a.ravel(), np.full(8, np.nan, np.float32)])
        b_at = np.concatenate([b.ravel(), np.full(8, np.nan, np.float32)])
        q = P.plan(M, N, K, bf16=True, n_sm=H100_SMS, splits=splits,
                   is_aligned=P.aligned(N, K, 0, 0))
        assert q.staged == (False, False) and q.ranges(K) == p.ranges(K)
        np.testing.assert_array_equal(
            product(a_at, 0, b_at, 0, M, K, N, q), got)
