"""The SSM and hybrid families through the port's serving path, held
against the JAX package's engine at the smoke sizes in fp32.

* Lockstep: the port's ``PartitionEngine`` beside the reference's on the
  same weights and load, paged and dense, with the decode step on the
  graph's static buffers, without graphs (``cuda_graph=False``) and with
  the card's prefill lifecycle emulated (eager run, capture, replays that
  rewrite the capture's outputs): a ragged wave prefilled one group per
  prompt length, then refills; identical occupancy and tokens, live
  logits within 2e-4.
* A group prefill is a non-ragged call of the prefill cache, keyed (params,
  slots, length, max_len, False); two engines on one cache share its
  entries and give the same tokens bit for bit.
* The refusals the reference makes (prefix cache, int8 / fp8 pages, sparse
  decode), with its messages, and the port's at a prompt shorter than the
  conv tail.
* PD: a slot's export carries its SSM state and conv window; over the wire
  and into another engine they arrive bit for bit, and the migrated decode
  equals a never-migrated one; a handoff crosses to the reference's
  engine and back.
* The serve CLI with ``--smoke --device cpu`` for both archs, as
  ``tests/test_serving.py`` runs the reference on mamba2, and the prefill
  profiler's whole-load A/B (``fleet_ab``) on both.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.models import api as japi
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro.serving import SimulatedEngine as JSim
from repro.serving.cluster import protocol as JP
from repro.serving.pd import apply_handoff as japply
from repro.serving.pd import export_handoff as jexport
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.profiling import prefill_profile
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import PrefillGraphs
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.pd import apply_handoff, export_handoff
from test_torch_prefill_graph import Emulated, _EmulatedOp

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["mamba2_130m", "hymba_1p5b"]
FAMILY = {"mamba2_130m": "ssm", "hymba_1p5b": "hybrid"}
SLOTS = 3
LENS = [9, 5, 9, 6, 6, 7, 6]     # a wave of two lengths, then four refills,
GENS = [4, 6, 3, 5, 4, 3, 4]     # three of one shape
SSM_KEYS = ("ssm_state", "ssm_conv")


@functools.lru_cache(maxsize=None)
def _built(arch):
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tapi.build(tcfg, "cpu")
    return (jcfg, jm, jp), (tcfg, tm, params_from_jax(jp, "cpu"))


def _max_len(cfg):
    return (cfg.n_meta_tokens or 0) + max(LENS) + max(GENS)


def _load(eng, q, lens=LENS, gens=GENS, seed=7):
    rng = np.random.default_rng(seed)
    for n, g in zip(lens, gens):
        q.submit(rng.integers(1, 256, size=(n,)).astype(np.int32), g)
    eng.assign(q.pop(len(lens)))


def _tengine(arch, pid=0, **kw):
    _, (tcfg, tm, tp) = _built(arch)
    return TEngine(tcfg, tm, tp, slots=SLOTS, max_len=_max_len(tcfg),
                   pid=pid, peak_flops=hw.TPU_PEAK_FLOPS, block_size=4,
                   **kw)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, paged):
    """The reference engine's run: per step the occupancy and the live
    slots' logits, then its tokens and refill count."""
    (jcfg, jm, jp), _ = _built(arch)
    eng = JEngine(jcfg, jm, jp, slots=SLOTS, max_len=_max_len(jcfg),
                  paged=paged, peak_flops=hw.TPU_PEAK_FLOPS, block_size=4)
    _load(eng, JQueue())
    eng.prefill_wave(0.0)
    steps = []
    while eng.busy:
        occ = [r and r.rid for r in eng.active]
        eng.decode_step(0.0)
        steps.append((occ, {i: np.asarray(eng.last_logits[i]).copy()
                            for i, rid in enumerate(occ) if rid is not None}))
    return steps, eng.slot_tokens, eng.n_refills


MODES = {"graph": {}, "eager": dict(cuda_graph=False), "emulated": "emulated"}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, paged, mode):
    steps, tokens, refills = _reference_run(arch, paged)
    kw = MODES[mode]
    if kw == "emulated":
        kw = dict(prefill_graphs=Emulated(_built(arch)[1][1]))
        for seed in (1, 2):     # the wave's groups: eager, then captured
            primer = _tengine(arch, paged=paged, **kw)
            _load(primer, TQueue(), LENS[:SLOTS], GENS[:SLOTS], seed=seed)
            primer.prefill_wave(0.0)
    eng = _tengine(arch, paged=paged, **kw)
    _load(eng, TQueue())
    eng.prefill_wave(0.0)
    for k, (occ, logits) in enumerate(steps):
        assert [r and r.rid for r in eng.active] == occ, k
        eng.decode_step(0.0)
        for i, want in logits.items():
            np.testing.assert_allclose(eng.last_logits[i], want, **TOL,
                                       err_msg=f"step {k} slot {i}")
    assert not eng.busy
    assert eng.slot_tokens == tokens
    assert eng.n_refills == refills == len(LENS) - SLOTS
    if mode == "emulated":    # both groups and a refill shape captured
        pg = eng.prefill_graphs
        assert pg.n_captures == 3 and pg.n_replays == 3 + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_group_prefills_are_non_ragged_keys_shared_by_engines(arch):
    _, (tcfg, tm, tp) = _built(arch)
    pg = PrefillGraphs(tm)
    meta = tcfg.n_meta_tokens or 0
    runs = []
    for pid in range(2):
        eng = _tengine(arch, pid=pid, prefill_graphs=pg)
        _load(eng, TQueue())
        eng.prefill_wave(0.0)
        wave_keys = set(pg.uses)
        logits = []
        while eng.busy:
            eng.decode_step(0.0)
            logits.append(eng.last_logits.copy())
        runs.append((eng, logits, len(pg)))
        if pid == 0:
            groups = {pg.key(tp, SLOTS, n, _max_len(tcfg), False)
                      for n in LENS[:SLOTS]}
            assert wave_keys == groups and len(groups) == 2
            refills = {pg.key(tp, 1, n, meta + n, False)
                       for n in LENS[SLOTS:]}
            assert set(pg.uses) == groups | refills
    (a, la, na), (b, lb, nb) = runs
    assert na == nb == len(pg.uses)
    assert b.slot_tokens == a.slot_tokens
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


REFUSED = {"prefix cache": (dict(prefix_cache=True),
                            "prefix caching is not supported for the {}"),
           "int8": (dict(kv_dtype="int8"),
                    "quantized / blockwise-sparse KV is not supported for "
                    "the {}"),
           "fp8": (dict(kv_dtype="fp8"),
                   "quantized / blockwise-sparse KV is not supported for the "
                   "{}"),
           "sparse": (dict(sparse_threshold=0.1),
                      "quantized / blockwise-sparse KV is not supported for "
                      "the {}")}


@pytest.mark.parametrize("lever", sorted(REFUSED))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_levers_the_reference_refuses(arch, lever):
    kw, msg = REFUSED[lever]
    match = msg.format(f"'{FAMILY[arch]}' family")
    (jcfg, _, _), _ = _built(arch)
    with pytest.raises(ValueError, match=match):
        JSim(jcfg, slots=SLOTS, max_len=32, **kw)
    with pytest.raises(ValueError, match=match):
        _tengine(arch, **kw)


def test_a_prompt_shorter_than_the_conv_tail_raises_at_prefill():
    eng = _tengine("mamba2_130m")
    _load(eng, TQueue(), lens=[2], gens=[3])
    with pytest.raises(ValueError, match=r"ssm_conv - 1 = 3"):
        eng.prefill_wave(0.0)
    # hymba's meta tokens make every prompt long enough
    eng = _tengine("hymba_1p5b")
    _load(eng, TQueue(), lens=[1, 2], gens=[3, 3])
    eng.prefill_wave(0.0)
    while eng.busy:
        eng.decode_step(0.0)
    assert [len(r.tokens) for r in eng.completed] == [3, 3]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _live_state(eng):
    """Each live slot's state by rid: its KV blocks in table order (or slab
    rows) and its SSM rows, as raw bits."""
    out = {}
    for i, req in enumerate(eng.active):
        if req is None:
            continue
        st = {}
        if eng.paged:
            tbl = torch.as_tensor(eng.slot_tables[i], dtype=torch.long)
            for k in ("k_pages", "v_pages"):
                if k in eng.pages:
                    st[k] = _bits(eng.pages[k][:, tbl]).clone()
            src = eng.pages
        else:
            src = eng.cache
            for k in ("k", "v"):
                if k in src:
                    st[k] = _bits(src[k][:, i]).clone()
        for k in SSM_KEYS:
            st[k] = _bits(src[k][:, i]).clone()
        out[req.rid] = st
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_migrated_decode_is_bit_identical_to_oracle(arch, paged):
    """Prefill on A, export, the wire both ways, import into a fresh B:
    the payload carries the SSM arrays, B's slot holds them bit for bit,
    and B's tokens, live logits and live state equal the never-migrated
    C's after every step."""
    lens, gens = LENS[:SLOTS], GENS[:SLOTS]
    a, c = _tengine(arch, paged=paged), _tengine(arch, paged=paged)
    for eng in (a, c):
        _load(eng, TQueue(), lens, gens)
        eng.prefill_wave(0.0)
    b = _tengine(arch, pid=1, paged=paged)
    want_names = set(SSM_KEYS) | ({"k", "v"} if arch == "hymba_1p5b"
                                  else set())
    for req in [r for r in a.active if r is not None]:
        i = [r and r.rid for r in a.active].index(req.rid)
        src = a.pages if paged else a.cache
        sent = {k: src[k][:, i].clone() for k in SSM_KEYS}
        h = export_handoff(a, req.rid)
        assert {pa.name for pa in h.pages} == want_names
        h2 = P.decode(P.encode(P.ImportKv(handoff=h))).handoff
        assert h2 == h
        j = apply_handoff(b, h2)
        dst = b.pages if paged else b.cache
        for k in SSM_KEYS:
            assert torch.equal(_bits(dst[k][:, j]), _bits(sent[k])), k
    assert not a.busy and b.n_imports == SLOTS
    steps = 0
    while c.busy:
        live = [i for i, r in enumerate(c.active) if r is not None]
        assert [r and r.rid for r in b.active] == \
            [r and r.rid for r in c.active]
        b.decode_step(0.0)
        c.decode_step(0.0)
        for i in live:
            np.testing.assert_array_equal(b.last_logits[i], c.last_logits[i])
        sb, sc = _live_state(b), _live_state(c)
        assert sb.keys() == sc.keys()
        for rid in sc:
            for k in sc[rid]:
                assert torch.equal(sb[rid][k], sc[rid][k]), (rid, k)
        steps += 1
    assert steps > 0
    assert sorted((r.rid, r.tokens) for r in b.completed) == \
        sorted((r.rid, r.tokens) for r in c.completed)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_an_export_is_a_copy_the_donor_no_longer_writes(arch, paged):
    """A slot's exported state is the host's own copy: the donor's next
    decode step, which advances every slot's SSM state in place (the freed
    slot's too) and writes idle slots' K/V rows, leaves it as exported."""
    eng = _tengine(arch, paged=paged)
    _load(eng, TQueue(), LENS[:SLOTS], GENS[:SLOTS])
    eng.prefill_wave(0.0)
    _, state = eng.export_kv(eng.active[0].rid)
    kept = {k: v.clone() for k, v in state["pages"].items()}
    eng.decode_step(0.0)
    for k, v in kept.items():
        assert torch.equal(state["pages"][k], v), k


@pytest.mark.parametrize("src_pkg", ["jax", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_crosses_between_the_packages(arch, src_pkg):
    """A slot prefilled on one package's engine decodes on the other's
    after the wire, its SSM state and conv window included, as a
    never-migrated engine of the source package does (2e-4; same
    tokens)."""
    (jcfg, jm, jp), _ = _built(arch)
    lens, gens = LENS[:2], GENS[:2]

    def jeng(pid=0):
        return JEngine(jcfg, jm, jp, slots=SLOTS, max_len=_max_len(jcfg),
                       pid=pid, peak_flops=hw.TPU_PEAK_FLOPS, block_size=4)
    make = {"jax": (jeng, JQueue),
            "torch": (lambda pid=0: _tengine(arch, pid), TQueue)}
    dst_pkg = "torch" if src_pkg == "jax" else "jax"
    (mk_src, q_src), (mk_dst, _) = make[src_pkg], make[dst_pkg]
    src, oracle = mk_src(), mk_src()
    for eng in (src, oracle):
        _load(eng, q_src(), lens, gens)
        eng.prefill_wave(0.0)
    dst = mk_dst(pid=1)
    for rid in [r.rid for r in src.active if r is not None]:
        if src_pkg == "jax":
            wire = JP.encode(JP.ImportKv(handoff=jexport(src, rid)))
            apply_handoff(dst, P.decode(wire).handoff)
        else:
            wire = P.encode(P.ImportKv(handoff=export_handoff(src, rid)))
            japply(dst, JP.decode(wire).handoff)
    while oracle.busy:
        live = [i for i, r in enumerate(oracle.active) if r is not None]
        dst.decode_step(0.0)
        oracle.decode_step(0.0)
        for i in live:
            np.testing.assert_allclose(np.asarray(dst.last_logits[i]),
                                       np.asarray(oracle.last_logits[i]),
                                       **TOL)
    assert not dst.busy
    assert sorted((r.rid, list(r.tokens)) for r in dst.completed) == \
        sorted((r.rid, list(r.tokens)) for r in oracle.completed)


@pytest.mark.parametrize("flags", [[], ["--dense"]], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_serve_cli_serves_the_new_archs_on_cpu(arch, flags, capsys):
    outs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "6", "--batch", "2", "--partitions",
                       "2", "--stagger", "demand", "--prompt-len", "8",
                       "--gen", "4", *flags])
    assert len(outs) == 4  # 2 partitions x 2 slots
    assert sum(len(o) for o in outs) == 6 * 4
    out = capsys.readouterr().out
    assert "completed=6/6" in out and "prefill graphs: " in out


def test_serve_cli_runs_a_hymba_pd_cluster_on_cpu(capsys):
    outs = serve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                       "--cluster", "2", "--router", "pd", "--pd-split",
                       "1:1", "--transport", "loopback", "--requests", "6",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert len(outs) == 6 and all(len(t) == 4 for t in outs)
    assert "split=1:1 handoffs=6" in out and "completed=6/6" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_ab_serves_the_ssm_families(arch, monkeypatch):
    """``prefill_profile.fleet_ab`` with the card's prefill lifecycle
    emulated: eager and graph fleets serve one load of mixed prompt
    lengths to the same tokens; a wave of several lengths is several
    group prefills, each a use of the cache; the context budget counts
    hymba's meta tokens."""
    _, (tcfg, tm, tp) = _built(arch)
    monkeypatch.setattr(PrefillGraphs, "op_type", _EmulatedOp)
    monkeypatch.setattr(prefill_profile, "GEN", 3)
    monkeypatch.setattr(prefill_profile, "SLOTS", 2)
    assert prefill_profile._prefix(tcfg) == (tcfg.n_meta_tokens or 0)
    lens = [5, 6, 5, 5, 7, 6, 5, 8]     # waves (5, 5) and (6, 5); 4 refills
    out = prefill_profile.fleet_ab(
        tcfg, tm, tp, {"mixed": (lens, {"eager": None, "graph": 64})})
    rec = out["mixed"]
    assert all(r["tokens"] == len(lens) * 3 for r in rec.values())
    pf = rec["graph"]["prefills"]
    assert pf["refills"] == 4 and pf["uses"] == 1 + 2 + 4
    assert pf["evictions"] == 0 and pf["replays"] > 0
