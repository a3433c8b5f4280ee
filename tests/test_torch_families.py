"""The MoE and VLM families and the dense family's other configs in the
port, held against the JAX package at the smoke sizes in fp32 (2e-4).

* Each config module equals the reference's (published and smoke).
* qwen3-moe, dbrx, internvl2 (its image prefix before the text) and the
  dense qwen1.5-4b (G = 1), mistral-nemo (d_head 128 != d / H) and
  qwen1.5-110b: a ragged prefill and 8 greedy decode steps, on a paged
  pool and on the dense slab, on the reference's weights: logits within
  2e-4 and the same argmax every step.
* Every published config's shapes pass the kernels' limits and plans:
  the matmul routes, flash attention's and the decode kernels' head and
  group limits, the decode split plan (whisper-base: its encoder's M = 4 x
  1500 rows, the 51,865-column tied head, the bidirectional (1500, 8, 64)
  attention and the cross attention's 1500-row walk at G = 1).
* internvl2's ``PartitionEngine`` in lockstep with the reference's engine
  (zero patch embeddings, the prefix counted in every slot's length):
  identical tokens.
* The graph engines' static-buffer path equals ``cuda_graph=False`` bit
  for bit for qwen3-moe and internvl2, and two internvl2 engines share
  one prefill cache: the second's wave and refills add no entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro.serving import kv_pool as JKV
from repro_torch.bridge import params_from_jax
from repro_torch.configs import PORTED_ARCH_IDS, get_config
from repro_torch.kernels import decode_split
from repro_torch.kernels.flash_attention import flash_attention as fa_k
from repro_torch.kernels.matmul import plan as mm_plan
from repro_torch.kernels.paged_attention import paged_attention as pa_k
from repro_torch.models import api as tapi
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import PrefillGraphs
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving import kv_pool as TKV

TOL = dict(rtol=2e-4, atol=2e-4)
NEW = ["qwen3_moe_30b_a3b", "dbrx_132b", "internvl2_26b", "qwen1p5_4b",
       "mistral_nemo_12b", "qwen1p5_110b"]
LENS = [12, 7, 10, 3]
WIDTH, MAX_LEN, BS = 12, 40, 8


def _cfgs(arch):
    return (jget_config(arch, smoke=True).replace(dtype="float32"),
            get_config(arch, smoke=True).replace(dtype="float32"))


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    assert arch in PORTED_ARCH_IDS
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jget_config(arch, smoke=smoke))


def _tree(p, leaf):
    return {k: _tree(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in p.items()}


@pytest.mark.parametrize("arch", NEW)
def test_init_lm_matches_reference_tree(arch):
    jcfg = jget_config(arch, smoke=True)
    jp = jax.eval_shape(japi.build(jcfg).init, jax.random.PRNGKey(0))
    tp = tapi.build(get_config(arch, smoke=True), "cpu").init(
        torch.Generator().manual_seed(0))
    assert _tree(tp, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == \
        _tree(jp, lambda a: (tuple(a.shape), str(a.dtype)))


def _batch(cfg, toks, lib):
    """The prompt batch, a VLM's with seeded patch embeddings, as jax
    arrays or torch tensors."""
    b = {"tokens": toks}
    if cfg.n_img_tokens:
        b["img_embeds"] = np.random.default_rng(4).standard_normal(
            (toks.shape[0], cfg.n_img_tokens, cfg.d_model), np.float32)
    return {k: jnp.asarray(v) if lib is jnp else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch, paged):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jp, "cpu")
    jprefill = jax.jit(jm.prefill, static_argnames="max_len")
    rng = np.random.default_rng(11)
    toks = np.zeros((len(LENS), WIDTH), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, 256, size=n)
    max_len = MAX_LEN + (jcfg.n_img_tokens or 0)
    jl, jc = jprefill(jp, _batch(jcfg, toks, jnp), max_len=max_len,
                      lens=jnp.asarray(LENS))
    tl, tc = tm.prefill(tp, _batch(tcfg, toks, torch), max_len=max_len,
                        lens=torch.tensor(LENS))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if paged:
        T = max_len // BS
        tables = np.random.default_rng(12).permutation(
            np.arange(1, 1 + len(LENS) * T)).reshape(len(LENS), T)
        tables = tables.astype(np.int32)
        n_blocks = 1 + len(LENS) * T
        jc = JKV.write_prefix_pages(JKV.init_pages(jcfg, n_blocks, BS),
                                    jc["k"], jc["v"], jnp.asarray(tables))
        tc = TKV.write_prefix_pages(
            TKV.init_pages(tcfg, n_blocks, BS, device="cpu"), tc["k"],
            tc["v"], torch.from_numpy(tables))
        lens = np.asarray(LENS, np.int32) + (jcfg.n_img_tokens or 0)
        jc.update(tables=jnp.asarray(tables), lens=jnp.asarray(lens))
        tc.update(tables=torch.from_numpy(tables), lens=torch.from_numpy(lens))
    jstep, tstep = (jm.decode_paged, tm.decode_paged) if paged else \
        (jm.decode, tm.decode)
    jstep = jax.jit(jstep)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1)[:, None]
    for step in range(8):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = tstep(tp, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        jtok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl[:, 0], -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# the matmuls whose bf16 operands are not 16-byte rows (N or K not a
# multiple of 8): the plan sends them to the tensor cores like the rest,
# with B (N odd) staged through its windows
STAGED_MATMULS = {"internvl2_26b": {"head"},
                  "hymba_1p5b": {"ssm in_proj", "head"},
                  "whisper_base": {"head"}}


def _matmuls(cfg):
    """(name, K, N) of every matmul a block issues through the wrapper."""
    d, out = cfg.d_model, []
    if cfg.family != "ssm":
        hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        out += [("wq", d, Hq * hd), ("wk", d, Hkv * hd), ("wo", Hq * hd, d)]
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        n_in = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + \
            cfg.ssm_heads
        out += [("ssm in_proj", d, n_in), ("ssm out_proj", d_inner, d)]
    f = cfg.d_ff * max(1, cfg.n_shared_experts)
    if f and not cfg.n_experts:
        out += [("w1", d, f), ("w2", f, d)]
    return out


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_published_shapes_pass_the_kernel_plans(arch):
    cfg = get_config(arch)
    staged = STAGED_MATMULS.get(arch, set())
    prompt = 32 + (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0)
    # an enc-dec wave runs the encoder and the cross K/V on its frames
    for M in (4, 4 * prompt) + ((4 * cfg.enc_seq,) if cfg.enc_seq else ()):
        for name, K, N in _matmuls(cfg):
            p = mm_plan.plan(M, N, K, bf16=True, n_sm=132,
                             is_aligned=mm_plan.aligned(N, K, 0, 0))
            assert p.route == "mma", (name, M, K, N)
            assert p.staged == (False, name in staged), (name, M, K, N)
            assert 1 <= p.splits and (p.splits - 1) * p.rows < K
            # where TMA reads both in place: the warpgroup routes' limits
            if name in staged:
                continue
            q = mm_plan.plan(M, N, K, bf16=True, n_sm=132, tma=True,
                             is_aligned=mm_plan.aligned(N, K, 0, 0))
            if M >= mm_plan.WG_MIN_M:
                assert q.route == "wgmma" and q.bn in mm_plan.WG_BNS
            elif q.route == "wgmma":
                assert M == mm_plan.WG_WAVE_M and q.bn in mm_plan.WG_BNS
                assert K * N >= mm_plan.WG_WAVE_KN or not \
                    mm_plan.stream_takes(M, N, K, 132)
            elif q.route == "stream":
                assert mm_plan.STREAM_MIN_M <= M < mm_plan.WG_MIN_M
                assert K >= mm_plan.STREAM_MIN_K
                assert -(-N // mm_plan.STREAM_BN) >= (
                    mm_plan.STREAM_MIN_TILES if M >= mm_plan.STREAM_WIDE_M
                    else 132)
                assert mm_plan.stream_tiles(M, N) <= mm_plan.STREAM_TILES
                assert 1 <= q.ctas <= 132 and q.units == \
                    mm_plan.stream_units(M, N, K)
            else:
                assert q.route == "mma" and q == p, (name, M, K, N, q)
    head = mm_plan.plan(4, cfg.vocab, cfg.d_model, bf16=True, n_sm=132,
                        is_aligned=mm_plan.aligned(cfg.vocab, cfg.d_model,
                                                   0, 0))
    assert (head.route, head.staged) == ("mma", (False, "head" in staged))
    if cfg.family == "ssm":
        return
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    assert Hq % Hkv == 0 and hd % 8 == 0
    assert hd <= fa_k.MAX_D and G <= fa_k.MAX_GROUP
    assert hd <= pa_k.MAX_D and G <= pa_k.MAX_GROUP
    for walk in (48 + prompt, 4096) + ((cfg.enc_seq,) if cfg.enc_seq
                                       else ()):
        assert 1 <= decode_split.plan(4, Hkv, walk, 132) <= -(-walk // 32)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

ENGINE_LENS = [22, 13, 18, 9]


def _load(queue):
    rng = np.random.default_rng(7)
    for n in ENGINE_LENS:
        queue.submit(rng.integers(1, 256, size=(n,)).astype(np.int32), 4)


def _max_len(cfg):
    return 48 + (cfg.n_img_tokens or 0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_vlm_engine_matches_reference(paged):
    jcfg, tcfg = _cfgs("internvl2_26b")
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, "cpu")
    common = dict(slots=2, max_len=_max_len(jcfg), paged=paged,
                  peak_flops=hw.TPU_PEAK_FLOPS)
    ej = JEngine(jcfg, jm, jp, **common)
    et = TEngine(tcfg, tm, params_from_jax(jp, "cpu"), **common)
    for eng, q in ((ej, JQueue()), (et, TQueue())):
        _load(q)
        eng.assign(q.pop(len(ENGINE_LENS)))
        eng.prefill_wave(0.0)
    assert et.slot_lens == ej.slot_lens
    assert et.slot_lens[0] == jcfg.n_img_tokens + ENGINE_LENS[0]
    while ej.busy:
        occupancy = [r and r.rid for r in ej.active]
        assert [r and r.rid for r in et.active] == occupancy
        ej.decode_step(0.0)
        et.decode_step(0.0)
        for i, rid in enumerate(occupancy):
            if rid is not None:
                np.testing.assert_allclose(et.last_logits[i],
                                           ej.last_logits[i], **TOL)
    assert et.slot_tokens == ej.slot_tokens
    assert et.n_refills == ej.n_refills > 0


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "internvl2_26b"])
def test_graph_engine_static_path_equals_eager(arch):
    _, tcfg = _cfgs(arch)
    tm = tapi.build(tcfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    engines = [TEngine(tcfg, tm, tp, slots=2, max_len=_max_len(tcfg),
                       cuda_graph=graph) for graph in (True, False)]
    for eng in engines:
        q = TQueue()
        _load(q)
        eng.assign(q.pop(len(ENGINE_LENS)))
        eng.prefill_wave(0.0)
    ge, ee = engines
    while ee.busy:
        for eng in engines:
            eng.decode_step(0.0)
        live = [i for i, r in enumerate(ee.active) if r is not None]
        np.testing.assert_array_equal(ge.last_logits[live],
                                      ee.last_logits[live])
    assert ge.slot_tokens == ee.slot_tokens and not ge.busy
    assert ge.graph.n_eager == ge.n_decode_steps > 0
    assert sum(ge.prefill_graphs.uses.values()) == 1 + ge.n_refills


def test_vlm_waves_and_refills_share_one_prefill_cache():
    """Two internvl2 graph engines on one ``PrefillGraphs`` serve the same
    load: the second adds no entry (its wave and refills find the first's
    shapes, the image prefix inside each step) and its tokens and logits
    equal the first's."""
    _, tcfg = _cfgs("internvl2_26b")
    tm = tapi.build(tcfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    pg = PrefillGraphs(tm)
    engines, sizes = [], []
    for _ in range(2):
        eng = TEngine(tcfg, tm, tp, slots=2, max_len=_max_len(tcfg),
                      prefill_graphs=pg)
        q = TQueue()
        _load(q)
        eng.assign(q.pop(len(ENGINE_LENS)))
        eng.prefill_wave(0.0)
        steps = []
        while eng.busy:
            eng.decode_step(0.0)
            steps.append(eng.last_logits.copy())
        engines.append((eng, steps))
        sizes.append(len(pg))
    (a, la), (b, lb) = engines
    assert sizes[0] == sizes[1] == len(pg.uses) > 1
    assert a.n_refills == b.n_refills > 0
    assert sum(pg.uses.values()) == 2 * (1 + a.n_refills)
    assert b.slot_tokens == a.slot_tokens
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
