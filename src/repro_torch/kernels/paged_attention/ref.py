"""Plain PyTorch versions of the paged decode-attention kernels: one query
token per slot against block-table-indexed KV pages with per-slot context
lengths, the math of ``repro/kernels/paged_attention/ref.py``.

Three variants share one attention body (gather each slot's chain into a
dense view, then masked softmax attention over it):

  * ``paged_decode_attention``        — float pages;
  * ``paged_decode_attention_quant``  — int8/fp8 packed pages with
    per-(block, kv-head) f32 scales, dequantized on the gather;
  * ``paged_decode_attention_sparse`` — blockwise-sparse: whole KV blocks
    whose estimated attention mass falls below a threshold are skipped.
    ``block_keep_mask`` is the single source of truth for *which* blocks
    survive; the CUDA kernels take the same mask.

Two operands the reference's oracles lack serve the model path: the
current token's ``k_row``/``v_row`` (the packed pool is requantized after
attention, so the exact new row stands in at ``cur_pos``) and a ``keep``
mask computed before the step's row is persisted.  Where the reference's
quant oracle keeps dequantized rows in f32, this one rounds them (and the
softmax weights) to q's dtype, as the reference's model path does
(``repro/models/layers.py:384-387``): identical in f32, within the bf16
tolerance otherwise.
"""
import math

import torch

_NEG = -1e30


def _attend(q, kd, vd, cur_pos, window: int, head_keep=None):
    """Masked decode attention over a dense (B, S, Hkv, D) view.
    ``head_keep`` (optional, (B, Hkv, S) bool) masks positions per kv-head
    on top of the causal/window mask."""
    B, Hq, D = q.shape
    S, Hkv = kd.shape[1], kd.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), kd.float()) / math.sqrt(D)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    cur = cur_pos.to(torch.int32)
    ok = pos[None, :] <= cur[:, None]                   # (B, S)
    if window and window > 0:
        ok &= pos[None, :] > (cur[:, None] - window)
    mask = ok[:, None, None, :]
    if head_keep is not None:
        mask = mask & head_keep[:, :, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(vd.dtype).float(), vd.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def gather_blocks(pages, tables):
    """``pages[tables]``: (B, T, ...) blocks through the table.  Packed fp8
    pages are gathered as bytes (not every device has fp8 index kernels)."""
    idx = tables.long()
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[idx].view(pages.dtype)
    return pages[idx]


def _put_row(view, row, cur_pos):
    """``view`` (B, S, Hkv, D) with each slot's ``row`` (B, Hkv, D) at its
    own position ``cur_pos[b]`` (clamped to the view, as the reference's
    ``dynamic_update_slice`` clamps)."""
    B, S = view.shape[:2]
    pos = cur_pos.long().clamp(0, S - 1)
    view = view.clone()
    view[torch.arange(B, device=view.device), pos] = row.to(view.dtype)
    return view


def paged_decode_attention(q, k_pages, v_pages, tables, cur_pos, *,
                           window: int = 0):
    """q: (B, Hq, D); pages: (N, bs, Hkv, D); tables: (B, T) int block ids
    into the pool; cur_pos: (B,) int — logical positions [0, cur_pos[b]] of
    slot b are valid (block t of slot b covers positions [t*bs, (t+1)*bs)).
    Returns (B, Hq, D)."""
    B = q.shape[0]
    _, bs, Hkv, D = k_pages.shape
    S = tables.shape[1] * bs
    kd = gather_blocks(k_pages, tables).reshape(B, S, Hkv, D)
    vd = gather_blocks(v_pages, tables).reshape(B, S, Hkv, D)
    return _attend(q, kd, vd, cur_pos, window)


def _dequant_gather(pages, scales, tables, dtype):
    """(B, T*bs, Hkv, D) float view of packed pages through the table."""
    B, T = tables.shape
    _, bs, Hkv, D = pages.shape
    x = gather_blocks(pages, tables).float() \
        * scales[tables.long()][:, :, None, :, None]
    return x.reshape(B, T * bs, Hkv, D).to(dtype)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, cur_pos, *, window: int = 0,
                                 k_row=None, v_row=None, keep=None):
    """Quantized-layout version: pages (N, bs, Hkv, D) int8/fp8 packed,
    scales (N, Hkv) f32 per (block, kv-head).  Dequantizes the dense gather
    (``x * scale``, rounded to q's dtype) and runs the float math.
    ``k_row``/``v_row`` ((B, Hkv, D), optional) replace the pool's row at
    ``cur_pos``; ``keep`` ((B, Hkv, T), optional) drops whole blocks."""
    kd = _dequant_gather(k_pages, k_scales, tables, q.dtype)
    vd = _dequant_gather(v_pages, v_scales, tables, q.dtype)
    if k_row is not None:
        kd = _put_row(kd, k_row, cur_pos)
        vd = _put_row(vd, v_row, cur_pos)
    head_keep = None
    if keep is not None:
        head_keep = torch.repeat_interleave(keep.bool(), k_pages.shape[1],
                                            dim=-1)
    return _attend(q, kd, vd, cur_pos, window, head_keep=head_keep)


def valid_blocks(cur_pos, T: int, bs: int, window: int = 0):
    """(B, T) bool: blocks that start at or before ``cur_pos`` and reach
    into the window (``window`` <= 0: no window)."""
    cur = cur_pos.to(torch.int32)
    blk = torch.arange(T, dtype=torch.int32, device=cur.device)
    valid = blk[None, :] * bs <= cur[:, None]
    if window and window > 0:
        valid &= (blk[None, :] + 1) * bs - 1 > (cur[:, None] - window)
    return valid


def block_mass(q, k_pages, tables, cur_pos, *, window: int = 0,
               k_scales=None):
    """(B, Hkv, T) f32: each block's estimated attention mass, the
    quantity ``block_keep_mask`` thresholds.

    Estimated from the block's mean key (the mean over all ``bs`` rows of
    the block, including rows past a slot's length): the max over the GQA
    group of ``q . mean_k / sqrt(D)``, softmaxed over the slot's valid
    blocks (invalid blocks get 0).  ``k_scales`` ((N, Hkv) f32)
    dequantizes packed pages first (the scale is constant over a block).
    The mean is taken over the table's blocks only, where the reference
    averages the whole pool and then gathers: the same numbers per block.
    """
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    T = tables.shape[1]
    G = Hq // Hkv
    kb = gather_blocks(k_pages, tables)               # (B, T, bs, Hkv, D)
    if k_scales is not None:
        km = kb.float().mean(dim=2) * k_scales[tables.long()][..., None]
    else:
        km = kb.mean(dim=2)                           # (B, T, Hkv, D)
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qr.float(),
                     km.to(qr.dtype).float()) / math.sqrt(D)
    s = s.amax(dim=2)                                 # (B, Hkv, T)
    valid = valid_blocks(cur_pos, T, bs, window)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG))
    return torch.softmax(s, dim=-1) * valid[:, None, :]


def block_keep_mask(q, k_pages, tables, cur_pos, *, threshold: float,
                    window: int = 0, k_scales=None):
    """(B, Hkv, T) bool: which KV blocks each (slot, kv-head) reads.

    Blocks whose estimated mass (``block_mass``) falls below ``threshold``
    are dropped whole; the block holding ``cur_pos`` is always kept (the
    new token's own row lives there), and blocks wholly outside the
    causal/window range never count.  ``threshold == 0`` keeps every
    valid block.
    """
    bs, T = k_pages.shape[1], tables.shape[1]
    cur = cur_pos.to(torch.int32)
    valid = valid_blocks(cur, T, bs, window)[:, None, :]
    p = block_mass(q, k_pages, tables, cur, window=window, k_scales=k_scales)
    keep = (p >= threshold) & valid
    blk = torch.arange(T, dtype=torch.int32, device=cur.device)
    keep |= (blk[None, None, :] == (cur[:, None, None] // bs)) & valid
    return keep


def paged_decode_attention_sparse(q, k_pages, v_pages, tables, cur_pos, *,
                                  threshold: float = 0.0, window: int = 0,
                                  keep=None):
    """Blockwise-sparse version: positions inside dropped blocks are masked
    out wholesale before the softmax.  Selection comes from
    ``block_keep_mask`` unless ``keep`` ((B, Hkv, T)) is given; at
    ``threshold == 0`` this is exactly the dense version."""
    B = q.shape[0]
    _, bs, Hkv, D = k_pages.shape
    S = tables.shape[1] * bs
    if keep is None:
        keep = block_keep_mask(q, k_pages, tables, cur_pos,
                               threshold=threshold, window=window)
    head_keep = torch.repeat_interleave(keep.bool(), bs, dim=-1)
    kd = gather_blocks(k_pages, tables).reshape(B, S, Hkv, D)
    vd = gather_blocks(v_pages, tables).reshape(B, S, Hkv, D)
    return _attend(q, kd, vd, cur_pos, window, head_keep=head_keep)
