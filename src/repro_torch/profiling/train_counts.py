"""What one training step issues and computes, from the config alone: the
kernel launches each microbatch issues through the wrappers, and the
products' and the SSD's operations behind the step's bound.

The counts follow the code of ``models/`` (``transformer.forward_hidden``
and ``loss_fn``, ``encdec.forward_encdec`` and ``loss_encdec``):

* every projection and LM head goes through ``kernels.matmul.ops.matmul``:
  its forward, and under ``torch.utils.checkpoint`` (``cfg.remat ==
  "full"``, and always for a loss chunk) its recompute, then its two
  backward products (dA, dB);
* every attention goes through ``FlashAttention``: its forward with the
  log-sum-exp (again in a recompute) and one backward (three kernels);
* an MoE block's router (f32, ``torch.matmul``) and its experts
  (``torch.bmm``) are torch calls, not wrappers; only the attention's four
  projections and any shared experts' three are counted;
* whisper's encoder runs without checkpoints, its decoder blocks under
  them, and its head is one unchunked product.

``train_issues`` gives the launches, ``issued_steps`` how many of a run's
steps issue them (a graphed step's replays issue none), ``train_flops``
the operations of one step (the least work: a forward and a backward, no
recompute), by part.
A CPU test holds ``train_issues`` against counting stand-ins of the
wrappers' plain versions over one step of each family.
"""
from __future__ import annotations

H100_BF16 = 989e12           # dense bf16 tensor-core FLOP/s, data sheet
H100_FP32 = 67e12            # float32 FLOP/s outside the tensor cores


def _chunk(S: int, chunk: int) -> int:
    """``transformer.chunked_ce``'s chunk: min(chunk, S) lowered until it
    divides S."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def _prefix(cfg) -> int:
    return (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0)


def block_products(cfg):
    """(K, N) of each product one decoder block issues through the matmul
    wrapper, in the order the block issues them."""
    d = cfg.d_model
    out = []
    if cfg.family != "ssm":
        hd = cfg.head_dim
        out += [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d)]
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        out += [(d, 2 * d_inner + 2 * G * N + H), (d_inner, d)]
    f = cfg.d_ff * (cfg.n_shared_experts if cfg.n_experts else 1)
    if f and cfg.family != "ssm":
        out += [(d, f)] * (2 if cfg.act == "silu" else 1) + [(f, d)]
    return out


def encdec_products(cfg):
    """(K, N) of an enc-dec encoder block's and decoder block's wrapper
    products: the attention's four (the cross attention's four in the
    decoder too) and the GELU MLP's two."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    attn = [(d, q), (d, kv), (d, kv), (q, d)]
    mlp = [(d, f), (f, d)]
    return attn + mlp, attn + attn + mlp


def train_issues(cfg, seq: int, micro_steps: int, loss_chunk: int = 256):
    """The launches ``micro_steps`` microbatches of ``seq`` positions each
    (the prefix included; a whisper microbatch's decoder tokens) issue:
    {"matmul", "flash_attention", "flash_attention_backward"} (the last
    counts calls, each three kernels)."""
    fwd = 2 if cfg.remat == "full" else 1       # forward (+ its recompute)
    if cfg.family == "encdec":
        enc, dec = encdec_products(cfg)
        mm = (cfg.enc_layers * len(enc) * 3 + cfg.n_layers * len(dec)
              * (fwd + 2) + 3)
        fa = cfg.enc_layers + cfg.n_layers * 2 * fwd
        bwd = cfg.enc_layers + cfg.n_layers * 2
    else:
        S_text = seq - _prefix(cfg)
        chunks = S_text // _chunk(S_text, loss_chunk)
        attn = cfg.family != "ssm"
        mm = cfg.n_layers * len(block_products(cfg)) * (fwd + 2) + 4 * chunks
        fa = cfg.n_layers * fwd * attn
        bwd = cfg.n_layers * attn
    return {"matmul": micro_steps * mm, "flash_attention": micro_steps * fa,
            "flash_attention_backward": micro_steps * bwd}


def issued_steps(n_steps: int, graphed: bool = True) -> int:
    """How many of one replica's ``n_steps`` steps issue their launches
    through the wrappers: every step of the unwrapped step function; of a
    ``TrainGraph`` (``runtime/train_graph.py``) on the card the first, run
    eagerly, and the second, the capture's pass, while the replays run the
    captured kernels without the wrappers."""
    return min(n_steps, 2) if graphed else n_steps


def _ssd_flops(cfg, S: int) -> int:
    """One sequence's forward SSD in ``models/ssm.ssm_block``: the chunk's
    scores (Q x Q over N) and their product with x (over Q), the chunk
    states and the cross-chunk term (P x N each), 2 FLOPs a multiply-add."""
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return 2 * S * H * (Q * N + Q * P + 2 * P * N)


def train_flops(cfg, seq: int, n_seqs: int) -> dict:
    """The operations of one step over ``n_seqs`` sequences of ``seq``
    positions (the prefix included; whisper's decoder tokens), forward and
    backward (3x the forward), by part: ``products`` (bf16, the tensor
    cores: every projection over the rows it runs on, an MoE's top_k
    experts a token, the head over the text), ``router`` and ``ssd`` (f32
    on the CUDA cores: an MoE's router, the SSD's einsums) and
    ``bound_ms``, each part over its rate, added."""
    d = cfg.d_model
    mnk = router = ssd = 0
    if cfg.family == "encdec":
        enc, dec = encdec_products(cfg)
        T = cfg.enc_seq
        mnk += cfg.enc_layers * T * sum(K * N for K, N in enc)
        # the decoder's: the cross attention's K and V run over the frames
        cross_kv = 2 * d * cfg.n_kv_heads * cfg.head_dim
        mnk += cfg.n_layers * (seq * (sum(K * N for K, N in dec) - cross_kv)
                               + T * cross_kv)
        mnk += seq * d * cfg.vocab
    else:
        mnk += cfg.n_layers * seq * sum(K * N for K, N in block_products(cfg))
        if cfg.n_experts:
            mnk += cfg.n_layers * seq * cfg.top_k * 3 * d * cfg.d_ff
            router = 2 * cfg.n_layers * seq * d * cfg.n_experts
        mnk += (seq - _prefix(cfg)) * d * cfg.vocab
        ssd = (cfg.n_layers * _ssd_flops(cfg, seq)
               if cfg.family in ("ssm", "hybrid") else 0)
    products, router, ssd = (3 * 2 * mnk * n_seqs, 3 * router * n_seqs,
                             3 * ssd * n_seqs)
    return dict(products=products, router=router, ssd=ssd,
                bound_ms=(products / H100_BF16
                          + (router + ssd) / H100_FP32) * 1e3)
