"""Paged KV-cache pool: block-table allocator + page scatter/gather helpers.

The dense per-wave cache (one ``(L, B, max_len, Hkv, D)`` slab per engine)
couples every slot to one prompt length and one write position, which is why
the seed engine raised on ragged prefill waves and absorbed refilled
requests at the shared-prefix boundary.  Paged storage breaks the coupling:
the engine owns a pool of fixed-size token blocks (``block_size`` tokens
each, all layers of one block stored together), every slot holds a *block
table* — the ordered list of block ids backing its context — and a per-slot
length.  Slots with different prompt lengths or chain histories share one
pool; freeing a slot returns its blocks for immediate reuse.

Two layers live here:

  * ``BlockPool`` — host-side free-list accounting.  Pure bookkeeping (no
    torch), shared by the real and the simulated engine so admission /
    exhaustion behaviour is identical with and without model execution.
    Block id 0 is reserved as the *null block*: inactive decode slots point
    their tables at it so their (masked, discarded) cache writes land
    somewhere harmless.  Every live block carries a reference count; with
    ``prefix_cache=True`` the pool also keeps a hash-chain *prefix index*
    so chains whose token content shares a prefix share the underlying
    blocks (see "Prefix caching" below and ``docs/prefix_caching.md``).
  * torch page helpers — ``init_pages`` / ``write_prefix_pages`` create
    and fill the device-resident page tensors
    ``(L, n_blocks, block_size, Hkv, D)`` at prefill time.  The decode-time
    hot path (per-token append, then attention) lives in
    ``models.layers.attention_decode_paged``; on the card the CUDA kernel in
    ``repro_torch.kernels.paged_attention`` streams the same layout without
    a dense gather.

The allocator half is the reference's ``serving/kv_pool.py`` copied
unchanged; only the page helpers are rewritten for torch.

Prefix caching
--------------
vLLM-style automatic prefix caching, block-granular.  Each full block of a
slot's *prompt content* is published in the index under a chain key —
``(parent_key, block token tuple)`` interned to an id, so two chains share
a block only when every token up to and including that block matches.  At
admission ``alloc_chain`` walks the index: matched full blocks are
reference-shared (refcount incremented, never rewritten), the divergent
tail is freshly allocated, and a matched *partial* final block is resolved
by copy-on-write — the matcher's first write lands immediately (the tail
prefill, or the next decode append), so the copy happens eagerly at match
time into an owned tail block, which keeps ``PoolExhausted`` out of the
decode hot path and means no block with refcount > 1 is ever written.

A block whose refcount drops to zero while it is published stays *cached*:
off the free list, evictable.  Allocation takes free blocks first and then
evicts cached blocks LRU (chains enter the LRU leaf-first, so a parent is
never reclaimed before its children); ``PoolExhausted`` is raised only
when free + evictable together cannot cover the request.  With
``prefix_cache=False`` (the default) the index, the cached set, and
eviction are all inert and the pool is bit-for-bit the historical
free-list allocator.
"""
from __future__ import annotations

import math
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

NULL_BLOCK = 0

# parent key id of the first block in every chain (the interned-key root)
_ROOT = -1


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied; the caller must keep
    the request queued rather than silently truncating its context."""


@dataclass
class ChainAlloc:
    """Result of ``BlockPool.alloc_chain``: the block table plus what the
    prefix index contributed.  ``cached_tokens`` counts the cache positions
    whose content already lives in shared (or copied) blocks — the tokens
    the cost model should NOT price as prefill compute; ``shared_blocks``
    is the length of the reference-shared head of ``table`` (the engine
    masks exactly these entries out of its page scatter); ``cow_src`` is
    the matched partial block a copy-on-write resolved against (its first
    ``cow_len`` positions are the reusable content), or None."""
    table: List[int]
    cached_tokens: int = 0
    shared_blocks: int = 0
    cow_src: Optional[int] = None
    cow_len: int = 0


@dataclass
class _Match:
    """Peeked longest cached chain for a key-token sequence."""
    blocks: List[int] = field(default_factory=list)  # full shared blocks
    partial: Optional[int] = None                    # partial-tail block
    partial_len: int = 0


class BlockPool:
    """Refcounted free-list allocator over ``n_blocks`` blocks of
    ``block_size`` tokens, with an optional content-addressed prefix index.

    Invariants (pinned by the property tests in ``tests/test_kv_pool.py``):
    a live block id is never handed out twice, ``free`` validates its WHOLE
    argument before mutating anything (a bad id mid-sequence leaves the
    pool untouched — the same all-or-nothing contract as ``alloc``),
    exhaustion raises ``PoolExhausted`` instead of returning a short
    allocation, and eviction only ever reclaims published blocks whose
    refcount is zero.
    """

    def __init__(self, n_blocks: int, block_size: int, *,
                 prefix_cache: bool = False):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1 (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # id 0 reserved: inactive slots park their writes there
        self._free: List[int] = list(range(1, n_blocks))
        self._live: set = set()
        self._ref: Dict[int, int] = {}      # live block -> reference count
        # --- prefix index (inert when prefix_cache=False) ---
        self.prefix_cache = bool(prefix_cache)
        self._full: Dict[Tuple[int, tuple], int] = {}     # chain key -> block
        self._partial: Dict[Tuple[int, tuple], int] = {}  # partial key -> block
        self._key_ids: Dict[Tuple[int, tuple], int] = {}  # interned chain keys
        self._block_key: Dict[int, Tuple[str, Tuple[int, tuple]]] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        self.n_hits = 0      # alloc_chain calls that reused cached content
        self.n_cow = 0       # partial-block matches resolved by copy
        self.n_evicted = 0   # published ref-0 blocks reclaimed under pressure

    # -- capacity ------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._live)

    @property
    def n_cached(self) -> int:
        """Published blocks with refcount 0: reusable on a hit, evictable
        under pressure — capacity in waiting, not capacity consumed."""
        return len(self._cached)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions (0 for an
        empty budget: a zero-token chain must not burn a block)."""
        if n_tokens <= 0:
            return 0
        return int(math.ceil(n_tokens / self.block_size))

    def can_fit(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.n_free + self.n_cached

    # -- alloc / free --------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` blocks off the free list; all-or-nothing.  Under a
        prefix cache, ref-0 published blocks are evicted (LRU) to cover a
        shortfall before the allocation is refused."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            self._evict(n - len(self._free))
        if n > len(self._free):
            raise PoolExhausted(
                f"requested {n} blocks, {len(self._free)} free "
                f"(pool of {self.n_blocks}, block_size={self.block_size})")
        out, self._free = self._free[:n], self._free[n:]
        self._live.update(out)
        for b in out:
            self._ref[b] = 1
        return out

    def alloc_for_tokens(self, n_tokens: int) -> List[int]:
        return self.alloc(self.blocks_for(n_tokens))

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block.  The whole sequence is
        validated BEFORE any state mutates — a double free, a foreign id,
        or more occurrences than the block holds references all raise with
        the pool untouched (``alloc``'s all-or-nothing mirror).  A block
        whose last reference drops returns to the free list, unless it is
        published in the prefix index — then it parks in the cached LRU
        (leaf-first, so eviction reclaims children before parents)."""
        counts = Counter(b for b in blocks if b != NULL_BLOCK)
        for b, c in counts.items():
            if b not in self._live:
                raise ValueError(f"block {b} is not live (double free?)")
            if c > self._ref[b]:
                raise ValueError(
                    f"block {b} freed {c} times but holds only "
                    f"{self._ref[b]} reference(s)")
        to_cache: List[int] = []
        for b in blocks:
            if b == NULL_BLOCK:
                continue
            self._ref[b] -= 1
            if self._ref[b]:
                continue
            del self._ref[b]
            self._live.remove(b)
            if b in self._block_key:
                to_cache.append(b)
            else:
                self._free.append(b)
        for b in reversed(to_cache):  # children enter the LRU first
            self._cached[b] = None

    # -- prefix index --------------------------------------------------------
    def _intern(self, key: Tuple[int, tuple]) -> int:
        kid = self._key_ids.get(key)
        if kid is None:
            kid = len(self._key_ids)
            self._key_ids[key] = kid
        return kid

    def match(self, key_tokens: Sequence) -> _Match:
        """Peek (no mutation) the longest indexed chain covering a prefix
        of ``key_tokens``: whole matched blocks, then the longest partial
        continuation of that chain."""
        m = _Match()
        if not self.prefix_cache:
            return m
        bs = self.block_size
        parent = _ROOT
        for i in range(len(key_tokens) // bs):
            key = (parent, tuple(key_tokens[i * bs:(i + 1) * bs]))
            b = self._full.get(key)
            if b is None:
                break
            m.blocks.append(b)
            parent = self._key_ids[key]
        done = len(m.blocks) * bs
        rest = key_tokens[done:]
        for j in range(min(len(rest), bs - 1), 0, -1):
            b = self._partial.get((parent, tuple(rest[:j])))
            if b is not None:
                m.partial, m.partial_len = b, j
                break
        return m

    def peek_cached_tokens(self, key_tokens: Sequence) -> int:
        """Cache positions a chain for ``key_tokens`` would reuse right
        now (cost estimates, admission-control probes)."""
        m = self.match(key_tokens)
        return len(m.blocks) * self.block_size + m.partial_len

    def alloc_chain(self, key_tokens: Sequence,
                    n_tokens: int) -> ChainAlloc:
        """Allocate a ``n_tokens``-position chain, reusing indexed blocks
        covering a prefix of ``key_tokens``.  All-or-nothing: matched
        blocks are reference-shared first (protecting them from the
        eviction the tail allocation may trigger), and handed back if the
        tail cannot be covered.  The last table entry is always owned
        (never shared), so appends past the matched content cannot land in
        a shared block."""
        total = self.blocks_for(n_tokens)
        if not self.prefix_cache:
            return ChainAlloc(self.alloc(total))
        m = self.match(key_tokens)
        shared = m.blocks[:max(total - 1, 0)]
        for b in shared:
            self._incref(b)
        try:
            tail = self.alloc(total - len(shared))
        except PoolExhausted:
            self.free(shared)  # roll back: all-or-nothing
            raise
        out = ChainAlloc(shared + tail, len(shared) * self.block_size,
                         len(shared))
        if m.partial is not None and tail and len(shared) == len(m.blocks):
            # the matched partial block diverges on this chain's first
            # write, which is imminent (tail prefill / next decode append):
            # resolve the copy-on-write eagerly into the first owned tail
            # block rather than sharing a block that is about to be written
            out.cow_src, out.cow_len = m.partial, m.partial_len
            out.cached_tokens += m.partial_len
            self.n_cow += 1
        if out.cached_tokens:
            self.n_hits += 1
        return out

    def register_chain(self, key_tokens: Sequence, table: Sequence[int],
                       n_tokens: int) -> None:
        """Publish the first ``n_tokens`` positions of ``table`` (prompt
        content only — generated tokens are never shared) in the prefix
        index.  First writer wins: a key already mapping to another block
        keeps its mapping, and a block is published under at most one key.
        Publishing does not change refcounts — a published block becomes
        *cached* (evictable) only when its last reference drops."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        n_tokens = min(int(n_tokens), len(key_tokens))
        n_full = n_tokens // bs
        parent = _ROOT
        for i in range(n_full):
            key = (parent, tuple(key_tokens[i * bs:(i + 1) * bs]))
            b = int(table[i])
            if key not in self._full and b not in self._block_key:
                self._full[key] = b
                self._block_key[b] = ("full", key)
            parent = self._intern(key)
        r = n_tokens - n_full * bs
        if r and n_full < len(table):
            key = (parent, tuple(key_tokens[n_full * bs:n_full * bs + r]))
            b = int(table[n_full])
            if key not in self._partial and b not in self._block_key:
                self._partial[key] = b
                self._block_key[b] = ("partial", key)

    def _incref(self, b: int) -> None:
        if b in self._live:
            self._ref[b] += 1
        else:  # cached (published, ref 0): resurrect
            self._cached.pop(b)
            self._live.add(b)
            self._ref[b] = 1

    def _evict(self, n: int) -> None:
        """Reclaim up to ``n`` cached blocks, oldest first.  Only ref-0
        published blocks are candidates — live chains are untouchable."""
        while n > 0 and self._cached:
            b, _ = self._cached.popitem(last=False)
            kind, key = self._block_key.pop(b)
            index = self._full if kind == "full" else self._partial
            if index.get(key) == b:
                del index[key]
            self._free.append(b)
            self.n_evicted += 1
            n -= 1


# ---------------------------------------------------------------------------
# device-side page arrays (torch)
# ---------------------------------------------------------------------------

# KV storage dtypes the pool understands.  Byte widths are host-side
# metadata so the cost model can reprice KV traffic without touching a
# device; "fp32" means "store at the model's own compute dtype", "int8" and
# "fp8" are the packed layouts (per-(block, kv-head) f32 scales beside the
# pages; see ``docs/kv_quantization.md`` for the error budget).
KV_DTYPE_BYTES: Dict[str, int] = {"fp32": 4, "int8": 1, "fp8": 1}
KV_DTYPES = tuple(KV_DTYPE_BYTES)


def kv_dtype_supported(kv_dtype: str) -> bool:
    """fp8 needs a torch that ships ``float8_e4m3fn``; fp32/int8 are
    always available."""
    if kv_dtype not in KV_DTYPE_BYTES:
        return False
    if kv_dtype != "fp8":
        return True
    import torch
    return hasattr(torch, "float8_e4m3fn")


def _kv_qspec(kv_dtype: str):
    """(packed torch dtype, qmax) for a quantized layout name."""
    import torch

    if kv_dtype == "int8":
        return torch.int8, 127.0
    if kv_dtype == "fp8":
        if not kv_dtype_supported("fp8"):
            raise ValueError(
                "kv_dtype='fp8' needs torch.float8_e4m3fn, which this torch "
                "build does not provide; use 'int8'")
        return torch.float8_e4m3fn, float(torch.finfo(torch.float8_e4m3fn).max)
    raise ValueError(f"unknown quantized kv_dtype {kv_dtype!r}; "
                     f"expected one of {sorted(KV_DTYPE_BYTES)}")


def kv_dtype_name(pages) -> str:
    """The quantized layout name of a packed page tensor."""
    import torch

    return "int8" if pages.dtype == torch.int8 else "fp8"


def quantize_kv(x, kv_dtype: str):
    """Per-block-per-head abs-max quantization of KV rows.

    ``x``: ``(..., block_size, Hkv, D)`` float rows (any leading axes).
    Returns ``(q, scales)`` with ``q`` the same shape packed to the target
    dtype and ``scales`` shaped ``(..., Hkv)`` float32, one scale per
    (leading..., kv-head) tile — the whole ``(block_size, D)`` extent of a
    head shares one scale.  int8 rounds half to even (as ``jnp.round``)
    and clips to +-127, so the round-trip error is bounded by ``scale / 2``
    per element; fp8 (e4m3, qmax 448) casts and inherits the format's
    relative error instead.  Bit for bit the reference's ``quantize_kv``.
    """
    import torch

    qdt, qmax = _kv_qspec(kv_dtype)
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=(-3, -1))
    # floor keeps an all-zero block from dividing by zero; any real row's
    # abs-max dominates it, so the error bound is untouched
    scales = torch.clamp(amax / qmax, min=1e-12)
    q = xf / scales[..., None, :, None]
    if qdt == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdt), scales


def dequantize_kv(q, scales, dtype=None):
    """Inverse of ``quantize_kv``: ``q (..., bs, Hkv, D)`` packed values +
    ``scales (..., Hkv)`` back to float (``dtype`` or float32)."""
    x = q.float() * scales.float()[..., None, :, None]
    return x if dtype is None else x.to(dtype)


def init_pages(cfg, n_blocks: int, block_size: int, dtype=None, *,
               device, kv_dtype: str = "fp32") -> Dict:
    """Page tensors ``k/v: (L, n_blocks, block_size, Hkv, D)`` on
    ``device``, zero-filled; empty dict for attention-free families (their
    recurrent state is per-slot already).  With a quantized ``kv_dtype``
    the pages are packed (int8/fp8) and the dict carries
    ``k_scales``/``v_scales`` ``(L, n_blocks, Hkv)`` float32 — their
    presence is how downstream consumers detect the layout."""
    import torch

    if cfg.family == "ssm":
        return {}
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype != "fp32":
        qdt, _ = _kv_qspec(kv_dtype)
        sshape = (cfg.n_layers, n_blocks, cfg.n_kv_heads)
        return {"k_pages": torch.zeros(shape, dtype=qdt, device=device),
                "v_pages": torch.zeros(shape, dtype=qdt, device=device),
                "k_scales": torch.zeros(sshape, dtype=torch.float32,
                                        device=device),
                "v_scales": torch.zeros(sshape, dtype=torch.float32,
                                        device=device)}
    dt = dtype or getattr(torch, cfg.dtype)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def write_prefix_pages(pages: Dict, k, v, tables) -> Dict:
    """Scatter a batch of dense per-slot K/V prefixes into their blocks —
    ONE scatter per pool tensor, however many slots are installed.

    k/v: ``(L, B, S, Hkv, D)`` dense rows; ``tables``: ``(B, T)`` integer
    block chains, null-padded.  Whole blocks are written: positions past a
    slot's length carry garbage that per-slot length masking hides until
    decode appends overwrite it, and null-padded table entries land
    harmlessly in the null block (which no live slot ever reads).  A prefix
    longer than the table can hold is a caller bug and raises — this module
    never silently truncates context.

    When ``pages`` carries ``k_scales``/``v_scales`` (a quantized pool from
    ``init_pages(kv_dtype=...)``) this is the quantize-on-append path: each
    incoming block is packed with a fresh per-(layer, block, head) abs-max
    scale and both the packed values and the scales are scattered.

    The pool tensors are updated IN PLACE (where the reference returns new
    arrays); the same dict is returned so callers read like the reference.
    """
    import torch

    kp, vp = pages["k_pages"], pages["v_pages"]
    bs = kp.shape[2]
    L, B, S, Hkv, D = k.shape
    T = tables.shape[1]
    pad = T * bs - S
    if pad < 0:
        raise ValueError(
            f"prefix of {S} tokens exceeds the table capacity of "
            f"{T * bs} (T={T} blocks x block_size={bs}); the pool never "
            "silently truncates context")
    k_blk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) \
        .reshape(L, B * T, bs, Hkv, D)
    v_blk = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) \
        .reshape(L, B * T, bs, Hkv, D)
    idx = torch.as_tensor(tables, device=kp.device).reshape(-1).long()
    if "k_scales" in pages:
        name = kv_dtype_name(kp)
        kq, ks = quantize_kv(k_blk, name)
        vq, vs = quantize_kv(v_blk, name)
        # packed dtypes have no index_copy_ kernel: scatter their bytes
        kp.view(torch.uint8).index_copy_(1, idx, kq.view(torch.uint8))
        vp.view(torch.uint8).index_copy_(1, idx, vq.view(torch.uint8))
        pages["k_scales"].index_copy_(1, idx, ks)
        pages["v_scales"].index_copy_(1, idx, vs)
        return pages
    kp.index_copy_(1, idx, k_blk.to(kp.dtype))
    vp.index_copy_(1, idx, v_blk.to(vp.dtype))
    return pages
