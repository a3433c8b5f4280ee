"""The split plan of the decode-attention kernels (flash-decoding).

The decode template (``csrc/decode_attention.cuh``) serves one query token
per (slot, kv head).  One CTA per pair gives B * Hkv CTAs, 16 at
qwen2-7b's 4 slots and 4 kv heads, on a card with 132 SMs.  So each pair's
walk over its context is cut into ``splits`` contiguous slices of whole
32-row tiles, one CTA each; a second kernel then combines the slices'
partial softmax states in a fixed order.

``plan`` picks ``splits`` from the launch's static shapes alone: the slot
count, the kv heads, the walk's upper bound (``T * bs`` for a block table,
``S`` for a dense slab) and the SM count.  It never reads ``cur_pos`` (that
would sync the host on every layer), so an engine gets the same plan on
every step, whatever its slots hold.  ``split_slice`` is the slice a CTA
takes once it knows, on the device, how many rows ``n`` it walks; the CUDA
kernel computes the same bounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

KT = 32          # rows per tile (decode_attention.cuh: one per lane)
WAVES = 2        # cover the SMs about this many times over

_SMS: Dict[int, int] = {}     # SM count by CUDA device index, read once


def plan(B: int, Hkv: int, walk: int, sm_count: int) -> int:
    """CTAs per (slot, kv head): enough that ``B * Hkv * splits`` covers
    the SMs about ``WAVES`` times, never more than the walk's tiles and
    never fewer than 1."""
    tiles = max(1, -(-walk // KT))
    want = -(-WAVES * sm_count // max(1, B * Hkv))
    return max(1, min(want, tiles))


def split_slice(n: int, splits: int, s: int) -> Tuple[int, int]:
    """Walked rows ``[start, end)`` of split ``s`` when ``n`` rows are
    walked: ``ceil(tiles / splits)`` whole tiles each, in order; the last
    slices may be short or empty (``start == end``)."""
    tiles = -(-n // KT)
    per = -(-tiles // splits)
    return min(n, s * per * KT), min(n, (s + 1) * per * KT)


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def splits_for(q: torch.Tensor, Hkv: int, walk: int,
               splits: Optional[int]) -> int:
    """``splits`` as given (at least 1), else the plan for q's card."""
    if splits is None:
        return plan(q.shape[0], Hkv, walk, sm_count(q.device))
    if int(splits) < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    return int(splits)


def workspace(q: torch.Tensor, splits: int) -> Optional[torch.Tensor]:
    """The (splits, B, Hq, D + 2) f32 partials (acc[D], m, l) of a split
    launch, on q's device and stream; None when ``splits == 1`` (the
    kernel then writes the output itself)."""
    if splits == 1:
        return None
    B, Hq, D = q.shape
    return torch.empty((splits, B, Hq, D + 2), dtype=torch.float32,
                       device=q.device)
