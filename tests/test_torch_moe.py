"""The port's MoE FFN against the JAX reference's ``repro/models/moe.py``,
fp32 at the smoke sizes, on the same weights (``params_from_jax``).

* ``capacity`` equals the reference's over a grid.
* ``moe_block``: the same expert ids, outputs within 2e-4 and the same
  aux loss on seeded inputs; with every token routed to experts 0 and 1
  (the capacity overflows: the reference's colliding scatter zeroes the
  token kept at position C-1, and the port reproduces it without one);
  with a shared expert; and split into capacity groups (16 against 64
  tokens a group, the reference's own ``tests/test_models.py:79``).
* ``dispatch``'s slot tables equal the reference's two scatters run as a
  loop (the later write to a slot winning), with and without overflow.
* Experts are drawn one (layer, expert) matrix at a time, never one draw
  broadcast over E, and the parameter tree crosses from JAX exactly.
* ``PartitionEngine`` serving qwen3-moe in lockstep with the reference's
  engine: identical tokens (live logits within 2e-4) on a float pool, an
  int8 + sparse pool and with a prefix-cache hit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hw
from repro.models import api as japi
from repro.models import moe as JMOE
from repro.serving import PartitionEngine as JEngine
from repro.serving import RequestQueue as JQueue
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import api as tapi
from repro_torch.models import moe as TMOE
from repro_torch.serving import PartitionEngine as TEngine
from repro_torch.serving import RequestQueue as TQueue

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "qwen3_moe_30b_a3b"


def _cfgs(**kw):
    return (jget_config(ARCH, smoke=True).replace(dtype="float32", **kw),
            get_config(ARCH, smoke=True).replace(dtype="float32", **kw))


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(cf):
    for n_tokens in (1, 2, 4, 7, 12, 32, 128, 1000, 32768):
        for n_experts in (4, 8, 16, 128):
            for top_k in (1, 2, 4, 8):
                args = (n_tokens, n_experts, top_k, cf)
                assert TMOE.capacity(*args) == JMOE.capacity(*args), args


def _ref_eid(p, x, k):
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _case(name):
    """(cfg kwargs, x (B, S, d), router override, group_tokens)."""
    rng = np.random.default_rng(5)
    if name == "overflow":
        # every token to experts 0 and 1: 12 tokens on experts of
        # capacity 8, so tokens 8-11 overflow and the token at position
        # C-1 = 7 loses its slot to the clipped sentinel
        x = rng.standard_normal((1, 12, 64)).astype(np.float32) * 0.1
        x[..., 0] = 10.0
        return {}, x, {(0, 0): 5.0, (0, 1): 4.0}, 32768
    if name == "groups":
        x = rng.standard_normal((2, 32, 64)).astype(np.float32)
        return dict(capacity_factor=8.0), x, {}, 16
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    return (dict(n_shared_experts=1) if name == "shared" else {}), x, {}, \
        32768


@pytest.mark.parametrize("name", ["seeded", "overflow", "shared", "groups"])
def test_moe_block_matches_reference(name):
    kw, x, router, group = _case(name)
    jcfg, tcfg = _cfgs(**kw)
    p = JMOE.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if router:
        r = np.asarray(p["router"]).copy()
        for idx, v in router.items():
            r[idx] = v
        p = dict(p, router=jnp.asarray(r))
    tp = params_from_jax(p, "cpu")
    jo, ja = JMOE.moe_block(p, jcfg, jnp.asarray(x), group_tokens=group)
    to, ta = TMOE.moe_block(tp, tcfg, torch.from_numpy(x),
                            group_tokens=group)
    _, _, eid = TMOE.route(tp, tcfg, torch.from_numpy(x).reshape(-1, 64))
    np.testing.assert_array_equal(eid.numpy(),
                                  _ref_eid(p, x, jcfg.top_k))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert TMOE.moe_block(tp, tcfg, torch.from_numpy(x), aux=False)[1] \
        is None
    if name == "overflow":
        assert set(eid.flatten().tolist()) == {0, 1}
        norms = np.abs(np.asarray(jo)[0]).sum(-1)
        assert (norms[:7] > 0).all() and (norms[7:] == 0).all()
        np.testing.assert_array_equal(np.abs(to.numpy()[0]).sum(-1) == 0,
                                      norms == 0)
    if name == "groups":      # one group against four, as the reference
        one, _ = TMOE.moe_block(tp, tcfg, torch.from_numpy(x),
                                group_tokens=64)
        jone, _ = JMOE.moe_block(p, jcfg, jnp.asarray(x), group_tokens=64)
        np.testing.assert_allclose(one.numpy(), np.asarray(jone), **TOL)
        np.testing.assert_allclose(one.numpy(), to.numpy(), rtol=2e-3,
                                   atol=2e-3)


def _sequential_tables(eid, E, C):
    """The reference's two scatters as a loop over the stably sorted token
    copies, a later write to one slot replacing an earlier one."""
    T, K = eid.shape
    flat = eid.reshape(-1)
    buf_tok, inv_slot = np.full(E * C, T), np.full(T * K, E * C)
    load = np.zeros(E, int)
    for i in np.argsort(flat, kind="stable"):
        e = flat[i]
        pos, load[e] = load[e], load[e] + 1
        slot = e * C + min(pos, C - 1)
        buf_tok[slot] = i // K if pos < C else T
        if pos < C:
            inv_slot[i] = slot
    return inv_slot, buf_tok, load


@pytest.mark.parametrize("T,E,K,skew", [(24, 8, 2, 0), (12, 8, 2, 2),
                                        (40, 8, 4, 3), (128, 128, 8, 0)])
def test_dispatch_equals_the_sequential_scatter(T, E, K, skew):
    """``moe.dispatch`` against the colliding scatter's last-write result:
    experts 0 .. skew-1 take three quarters of the tokens (every token
    when ``skew`` is K), so they overflow."""
    rng = np.random.default_rng(T + E)
    rows = []
    for t in range(T):
        head = np.arange(skew if t < (T if skew == K else T * 3 // 4)
                         else 0)
        rest = rng.permutation(np.setdiff1d(np.arange(E), head))
        rows.append(np.concatenate([head, rest[:K - len(head)]]))
    eid = np.stack(rows)
    C = TMOE.capacity(T, E, K, 1.0)
    inv_slot, buf_tok = TMOE.dispatch(torch.from_numpy(eid), E, C)
    want_inv, want_buf, load = _sequential_tables(eid, E, C)
    np.testing.assert_array_equal(inv_slot.numpy(), want_inv)
    np.testing.assert_array_equal(buf_tok.numpy(), want_buf)
    assert not skew or (load > C).any()


def test_experts_are_drawn_one_matrix_at_a_time():
    _, tcfg = _cfgs(n_shared_experts=1)
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                      "cpu", n_layers=2)
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert p["w1"].shape == (2, E, d, f) and p["w2"].shape == (2, E, f, d)
    assert p["router"].dtype == torch.float32
    assert p["ws2"].shape == (2, f, d)
    for key in ("w1", "w2", "w3"):
        w = p[key].float()
        assert not torch.equal(w[0, 0], w[0, 1])     # two experts differ
        assert not torch.equal(w[0, 0], w[1, 0])     # and two layers
        flat = w.reshape(2 * E, -1)
        assert torch.linalg.matrix_rank(flat) == 2 * E
        assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_moe_tree(dtype):
    jcfg = jget_config(ARCH, smoke=True).replace(dtype=dtype)
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jp, "cpu")
    moe, jmoe = tp["blocks"]["moe"], jp["blocks"]["moe"]
    assert sorted(moe) == ["router", "w1", "w2", "w3"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].dtype == getattr(torch, dtype)
    L, E, d, f = (jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.d_ff)
    assert tuple(moe["w1"].shape) == (L, E, d, f)
    assert tuple(moe["w2"].shape) == (L, E, f, d)
    for key in moe:
        np.testing.assert_array_equal(
            moe[key].float().numpy(), np.asarray(jmoe[key], np.float32))
    assert tuple(tp["lm_head"].shape) == (d, jcfg.vocab)


# ---------------------------------------------------------------------------
# the serving engine against the reference's
# ---------------------------------------------------------------------------

LENS = [22, 13, 18, 9, 20]
HEAD = 16                   # requests 2 and 4 share a 16-token head


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = _cfgs()
    jm = japi.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    return (jcfg, jm, jparams), (tcfg, tapi.build(tcfg, "cpu"),
                                 params_from_jax(jparams, "cpu"))


def _load(queue):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=(n,)).astype(np.int32)
               for n in LENS]
    prompts[4][:HEAD] = prompts[2][:HEAD]
    for prompt in prompts:
        queue.submit(prompt, 4)


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8",
                                         sparse_threshold=0.1),
                                dict(prefix_cache=True)],
                         ids=["fp32", "int8+sparse", "prefix"])
def test_moe_engine_matches_reference(built, kw):
    (jcfg, jm, jp), (tcfg, tm, tp) = built
    qj, qt = JQueue(), TQueue()
    _load(qj)
    _load(qt)
    common = dict(slots=2, max_len=48, block_size=4,
                  peak_flops=hw.TPU_PEAK_FLOPS, **kw)
    dropped = pa_ops.paged_decode_quant.dropped_blocks.value
    ej = JEngine(jcfg, jm, jp, paged=True, **common)
    et = TEngine(tcfg, tm, tp, **common)
    for eng, q in ((ej, qj), (et, qt)):
        eng.assign(q.pop(len(LENS)))
        eng.prefill_wave(0.0)
    tol = TOL if "kv_dtype" not in kw else dict(rtol=5e-2, atol=5e-2)
    while ej.busy:
        occupancy = [r and r.rid for r in ej.active]
        assert [r and r.rid for r in et.active] == occupancy
        ej.decode_step(0.0)
        et.decode_step(0.0)
        for i, rid in enumerate(occupancy):
            if rid is not None:
                np.testing.assert_allclose(et.last_logits[i],
                                           ej.last_logits[i], **tol)
    assert not et.busy
    assert et.slot_tokens == ej.slot_tokens
    assert et.n_refills == ej.n_refills > 0
    if kw.get("prefix_cache"):
        assert et.n_prefix_hits == ej.n_prefix_hits > 0
    if kw.get("sparse_threshold"):
        assert pa_ops.paged_decode_quant.dropped_blocks.value > dropped
