"""The paged decode-attention wrappers the model's decode step calls.

Three variants, one convention, as in the JAX package: float pages
(``paged_decode``), packed int8/fp8 pages with per-(block, kv-head) scales
(``paged_decode_quant``) and blockwise-sparse float pages
(``paged_decode_sparse``: whole blocks below an estimated-attention-mass
threshold are skipped; the keep mask comes from ``ref.block_keep_mask``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel and adds one to the wrapper's ``launches``.  There is no
fallback: any other device, or a tensor the kernel does not take, raises.
The wrappers that take a keep mask also count, in ``dropped_blocks``, the
valid blocks their masks drop (on either device).
"""
from __future__ import annotations

import torch

from . import ref
from .paged_attention import (paged_decode_cuda, paged_decode_quant_cuda,
                              paged_decode_sparse_cuda)


class BlockCount:
    """Blocks dropped by keep masks, summed on each mask's device so that
    counting adds no host sync; ``value`` syncs once to read the total.

    Each device has one persistent int64 accumulator, updated in place
    (``add_``) and zeroed in place by ``reset``: a decode step captured as
    a CUDA graph records the add against the accumulator's address, so
    every replay keeps counting into the same tensor."""

    def __init__(self):
        self._sums = {}

    def add(self, n: torch.Tensor) -> None:
        acc = self._sums.get(n.device)
        if acc is None:
            acc = self._sums[n.device] = torch.zeros(
                (), dtype=torch.int64, device=n.device)
        acc.add_(n)

    @property
    def value(self) -> int:
        return sum(int(v) for v in self._sums.values())

    def reset(self) -> None:
        for acc in self._sums.values():
            acc.zero_()


def _count_dropped(counter: BlockCount, keep, cur_pos, bs: int,
                   window: int) -> None:
    valid = ref.valid_blocks(cur_pos, keep.shape[-1], bs, window)
    counter.add((valid[:, None, :] & ~keep.bool()).sum())


def _device(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, tables: torch.Tensor,
                 cur_pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int32;
    cur_pos: (B,) int32.  window <= 0 means no window.  Returns (B, Hq, D).
    The new token's K/V row must already be in the pool."""
    if _device(q, "paged_decode") == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, tables,
                                          cur_pos, window=window)
    out = paged_decode_cuda(q, k_pages, v_pages, tables, cur_pos,
                            window=window)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_sparse(q, k_pages, v_pages, tables, cur_pos, *,
                        threshold: float = 0.0, window: int = 0,
                        keep=None) -> torch.Tensor:
    """Blockwise-sparse paged decode over float pages.  ``keep`` ((B, Hkv,
    T) bool or int) is the selection; without it the mask is
    ``ref.block_keep_mask(..., threshold=threshold)`` on these pages.  The
    new token's K/V row must already be in the pool (and, on the model
    path, the mask computed before it was written)."""
    dev = _device(q, "paged_decode_sparse")
    if keep is None:
        keep = ref.block_keep_mask(q, k_pages, tables, cur_pos,
                                   threshold=threshold, window=window)
    _count_dropped(paged_decode_sparse.dropped_blocks, keep, cur_pos,
                   k_pages.shape[1], window)
    if dev == "cpu":
        return ref.paged_decode_attention_sparse(q, k_pages, v_pages, tables,
                                                 cur_pos, window=window,
                                                 keep=keep)
    out = paged_decode_sparse_cuda(q, k_pages, v_pages, tables, cur_pos,
                                   keep.to(torch.int32).contiguous(),
                                   window=window)
    paged_decode_sparse.launches += 1
    return out


paged_decode_sparse.launches = 0
paged_decode_sparse.dropped_blocks = BlockCount()


def paged_decode_quant(q, k_pages, v_pages, k_scales, v_scales, tables,
                       cur_pos, *, window: int = 0, k_row=None, v_row=None,
                       keep=None) -> torch.Tensor:
    """Paged decode over packed int8/fp8 pages (N, bs, Hkv, D) with (N,
    Hkv) f32 scales.  ``k_row``/``v_row`` ((B, Hkv, D), optional) stand in
    for the pool's row at ``cur_pos``; ``keep`` ((B, Hkv, T), optional)
    drops whole blocks (int8/fp8 + sparse)."""
    dev = _device(q, "paged_decode_quant")
    if keep is not None:
        _count_dropped(paged_decode_quant.dropped_blocks, keep, cur_pos,
                       k_pages.shape[1], window)
    if dev == "cpu":
        return ref.paged_decode_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, tables, cur_pos,
            window=window, k_row=k_row, v_row=v_row, keep=keep)
    out = paged_decode_quant_cuda(
        q, k_pages, v_pages, k_scales, v_scales, tables, cur_pos,
        window=window,
        k_row=None if k_row is None else k_row.contiguous(),
        v_row=None if v_row is None else v_row.contiguous(),
        keep=None if keep is None else keep.to(torch.int32).contiguous())
    paged_decode_quant.launches += 1
    return out


paged_decode_quant.launches = 0
paged_decode_quant.dropped_blocks = BlockCount()
