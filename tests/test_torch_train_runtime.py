"""The port's training substrate against the JAX package's.

* AdamW (``adamw_update``, ``global_norm``, ``cosine_lr``) and the int8
  error-feedback compression on the same numpy inputs; the data pipeline
  element for element; ``tradeoff_report``'s entries that no hardware
  constant prices equal, the NVLink-priced one from the H100 constant;
  ``accum_for_batch``, ``sync_params``, ``stack_tree``.
* Checkpoints: the on-disk layout is shared, so one written by either
  package restores in the other (bf16 bit for bit); keep-last-k.
* ``make_train_step`` with ``accum`` 1 and 2, two steps from the same
  weights (warmup 1: the first step's learning rate is 0), against
  ``jax.jit(make_train_step(api))``: loss and metrics, m and v at 2e-4
  (each against its RMS: |port - jax| <= tol * (rms + |jax|)), and each
  step's parameter update where the reference's first moment is above 1 %
  of its RMS (Adam's early updates are close to sign(m) x lr, so an
  entry whose m is near rounding noise may flip: at 2e-4 of the RMS
  three entries of a key-bias update do, at most 0.0017 x the RMS).
* ``PartitionRuntime``, as ``tests/test_substrate.py`` holds the
  reference's: replicas diverge between syncs and are equal bit for bit
  after one; a partition fails and is replaced; the loss falls.  Resume is
  exact; the train CLI runs end to end with ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import SMOKE_SHAPES, get_config as jget_config
from repro.configs.base import ShapeCell
from repro.core import partitioning as JP
from repro.data import pipeline as JDATA
from repro.models import api as japi
from repro.optim import adamw as JADAM
from repro.optim import compression as JCOMP
from repro.runtime import elastic as JEL
from repro.runtime import steps as JRS
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.core import partitioning as TP
from repro_torch.data import pipeline as TDATA
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as TADAM
from repro_torch.optim import compression as TCOMP
from repro_torch.runtime import elastic as TEL
from repro_torch.runtime import steps as TRS
from repro_torch.runtime.partition_runtime import PartitionRuntime
from repro_torch.tree import leaves, leaves_with_paths

TOL = 2e-4


def close(got, want, tol=TOL, what="", mask=None):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, what
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    lim = tol * (rms + np.abs(want))
    bad = err > lim
    if mask is not None:
        bad &= mask
    assert np.isfinite(got).all() and not bad.any(), (
        f"{what}: {int(bad.sum())} entries outside, max err {err.max():.3g} "
        f"(rms {rms:.3g})")


def jax_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = np.asarray(leaf)
    return out


def torch_paths(tree):
    return {p: t for p, t in leaves_with_paths(tree)}


def _tree(rng, shapes, dtype=np.float32):
    return {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}


SHAPES = {"w": (6, 5), "b": (5,), "e": (3, 4, 2)}

# ---------------------------------------------------------------------------
# optimizer, compression, data, accounting
# ---------------------------------------------------------------------------


def test_cosine_lr_equal():
    for step in (0, 1, 5, 99, 100, 101, 5000, 10_000, 20_000):
        j = JADAM.cosine_lr(jnp.asarray(step, jnp.int32), peak=3e-4,
                            warmup=100, total=10_000)
        t = TADAM.cosine_lr(torch.tensor(step, dtype=torch.int32), peak=3e-4,
                            warmup=100, total=10_000)
        assert t.dtype == torch.float32
        assert float(t) == float(j), step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_against_reference(dtype):
    rng = np.random.default_rng(0)
    p = _tree(rng, SHAPES)
    jp = {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    js, ts = JADAM.adamw_init(jp), TADAM.adamw_init(tp)
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    for i in range(3):
        g = _tree(rng, SHAPES)
        g["w"] *= 30.0                         # clip on the first steps
        jg = {k: jnp.asarray(v).astype(getattr(jnp, dtype))
              for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        lr = 1e-2 * (i + 1)
        jp, js, jm = JADAM.adamw_update(jg, js, jp, lr=lr)
        tp2, ts, tm = TADAM.adamw_update(tg, ts, tp, lr=lr)
        assert tp2 is tp                                      # in place
        close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        assert int(ts.step) == int(js.step) == i + 1
        for k in SHAPES:
            close(ts.m[k], js.m[k], 1e-6, f"m {k}")
            close(ts.v[k], js.v[k], 1e-6, f"v {k}")
            close(tp[k], jp[k], 1e-6 if dtype == "float32" else 1e-2,
                  f"p {k}")
            assert tp[k].dtype == getattr(torch, dtype)


def test_global_norm_and_init():
    rng = np.random.default_rng(1)
    g = _tree(rng, SHAPES)
    j = JADAM.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    t = TADAM.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    close(t, j, 1e-6, "global_norm")
    st = TADAM.adamw_init({k: torch.from_numpy(v).bfloat16()
                           for k, v in g.items()})
    assert all(m.dtype == torch.float32 and not m.any() for m in
               leaves(st.m) + leaves(st.v))


def test_compression_against_reference():
    rng = np.random.default_rng(2)
    g = _tree(rng, SHAPES)
    jerr = JCOMP.init_error_feedback({k: jnp.asarray(v) for k, v in g.items()})
    terr = TCOMP.init_error_feedback({k: torch.from_numpy(v)
                                      for k, v in g.items()})
    for _ in range(4):
        jq, jerr = JCOMP.compress_grads({k: jnp.asarray(v)
                                         for k, v in g.items()}, jerr)
        tq, terr = TCOMP.compress_grads({k: torch.from_numpy(v)
                                         for k, v in g.items()}, terr)
        for k in SHAPES:
            assert tq[k][0].dtype == torch.int8
            np.testing.assert_array_equal(tq[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            close(tq[k][1], jq[k][1], 1e-7, f"scale {k}")
            close(terr[k], jerr[k], 1e-6, f"error {k}")
        jd, td = JCOMP.decompress_grads(jq), TCOMP.decompress_grads(tq)
        for k in SHAPES:
            close(td[k], jd[k], 1e-6, f"decompressed {k}")


@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-26b", "hymba-1.5b",
                                  "whisper-base"])
@pytest.mark.parametrize("partitions", [1, 2])
def test_synth_lm_batch_equal(arch, partitions):
    shape = SMOKE_SHAPES["train_4k"]
    for step in (0, 7):
        j = JDATA.synth_lm_batch(jget_config(arch, smoke=True), shape, step,
                                 seed=3, partitions=partitions)
        t = TDATA.synth_lm_batch(get_config(arch, smoke=True), shape, step,
                                 seed=3, partitions=partitions)
        assert sorted(j) == sorted(t)
        for k in j:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_synth_image_batch_equal():
    j = JDATA.synth_image_batch(4, 8, 3, seed=1)
    t = TDATA.synth_image_batch(4, 8, 3, seed=1)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("P,W,compressed", [(1, 1, False), (4, 8, False),
                                            (2, 3, True)])
def test_tradeoff_report(P, W, compressed):
    n = 7_615_616_000
    jr = JP.tradeoff_report(n, JP.PartitionConfig(P, W,
                                                  compress_sync=compressed))
    tr = TP.tradeoff_report(n, TP.PartitionConfig(P, W,
                                                  compress_sync=compressed))
    assert set(tr) == set(jr)
    for k in ("partitions", "sync_every", "replica_bytes_total",
              "replica_bytes_per_device", "sync_bytes_per_step"):
        assert tr[k] == jr[k], k
    assert tr["sync_seconds_per_step_dcn"] == \
        tr["sync_bytes_per_step"] / hw.H100_NVLINK_BW
    assert tr["hbm_fraction_per_device"] == \
        n * 2 / 256 / (hw.H100_HBM_GB * 2 ** 30)
    assert TP.weight_replica_bytes(n, P) == JP.weight_replica_bytes(n, P)
    assert TP.sync_bytes_per_step(n, P, W) == JP.sync_bytes_per_step(n, P, W)
    with pytest.raises(ValueError):
        TP.PartitionConfig(0, 1)


def test_accum_sync_and_stack():
    for args in ((64, 4, 2, 1), (64, 4, 3, 2), (8, 2, 2, 4), (8, 3, 0, 1)):
        assert TEL.accum_for_batch(*args) == JEL.accum_for_batch(*args)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    js = JRS.stack_tree({"a": jnp.asarray(x[0])}, 3)
    ts = TRS.stack_tree({"a": torch.from_numpy(x[0])}, 3)
    np.testing.assert_array_equal(ts["a"].numpy(), np.asarray(js["a"]))
    jp, jo = JRS.sync_params({"a": jnp.asarray(x).astype(jnp.bfloat16)},
                             {"m": jnp.asarray(x), "n": jnp.asarray(2)})
    tp, to = TRS.sync_params({"a": torch.from_numpy(x).bfloat16()},
                             {"m": torch.from_numpy(x), "n": torch.tensor(2)})
    np.testing.assert_array_equal(tp["a"].float().numpy(),
                                  np.asarray(jp["a"], np.float32))
    close(to["m"], jo["m"], 1e-7, "m")
    assert int(to["n"]) == 2


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(rng):
    w = rng.standard_normal((3, 4)).astype(np.float32)
    return {"params": {"blocks": {"w": w}, "emb": w[:2] * 3},
            "opt": {"step": np.int32(7), "m": {"blocks": {"w": w * 0.5},
                                                "emb": w[:2]}}}


def test_checkpoint_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    s = _state(rng)
    jstate = {"params": {"blocks": {"w": jnp.asarray(s["params"]["blocks"][
        "w"]).astype(jnp.bfloat16)}, "emb": jnp.asarray(s["params"]["emb"])},
        "opt": {"step": jnp.asarray(7, jnp.int32),
                "m": {"blocks": {"w": jnp.asarray(s["opt"]["m"]["blocks"][
                    "w"])}, "emb": jnp.asarray(s["opt"]["m"]["emb"])}}}
    tstate = params_from_jax(jstate, "cpu")
    JCheckpointManager(tmp_path / "j").save(3, jstate, meta={"tag": "jax"})
    CheckpointManager(tmp_path / "t").save(3, tstate, meta={"tag": "torch"})
    # JAX's checkpoint into the port, and the port's into JAX
    zeros_t = params_from_jax(jax.tree.map(jnp.zeros_like, jstate), "cpu")
    got_t, meta = CheckpointManager(tmp_path / "j").restore(zeros_t)
    assert meta["step"] == 3 and meta["tag"] == "jax"
    got_j, meta = JCheckpointManager(tmp_path / "t").restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert meta["step"] == 3 and meta["tag"] == "torch"
    want = jax_paths(jstate)
    for path, t in leaves_with_paths(got_t):
        assert t.dtype == {"float32": torch.float32, "bfloat16":
                           torch.bfloat16, "int32": torch.int32}[
            str(want[path].dtype)]
        np.testing.assert_array_equal(t.float().numpy(),
                                      want[path].astype(np.float32))
    for path, a in jax_paths(got_j).items():
        assert a.dtype == want[path].dtype
        np.testing.assert_array_equal(a.astype(np.float32),
                                      want[path].astype(np.float32))
    with np.load(tmp_path / "t" / "step_3" / "arrays.npz") as z:
        assert sorted(z.files) == sorted(want)
        assert z["params/blocks/w"].dtype == np.float32   # bf16 upcast


def test_checkpoint_keep_k(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"m": torch.zeros((2, 3))}}
    for s in (1, 2, 3):
        cm.save(s, state, meta={"tag": s})
    assert cm.steps() == [2, 3] and cm.latest_step() == 3
    restored, meta = cm.restore({"params": {"w": torch.zeros(2, 3)},
                                 "opt": {"m": torch.ones(2, 3)}})
    torch.testing.assert_close(restored["params"]["w"], state["params"]["w"])
    assert meta["step"] == 3 and meta["tag"] == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, tapi.build(tcfg, "cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_against_reference(smoke, accum):
    jcfg, jm, jp0, tcfg, tm = smoke
    kw = dict(peak_lr=1e-2, warmup=1, total=50, accum=accum)
    jstep = jax.jit(JRS.make_train_step(jm, **kw))
    tstep = TRS.make_train_step(tm, **kw)
    shape = SMOKE_SHAPES["train_4k"]
    jp, jo = jp0, JADAM.adamw_init(jp0)
    tp = params_from_jax(jp0, "cpu")
    to = TADAM.adamw_init(tp)
    for step in range(2):
        b = TDATA.synth_lm_batch(tcfg, shape, step)
        jprev = jax_paths(jp)
        tprev = {k: v.clone() for k, v in torch_paths(tp).items()}
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = tstep(tp, to, b)
        assert set(tmet) == set(jmet)
        for k in jmet:
            close(tmet[k], jmet[k], TOL, f"step {step} {k}")
        jm_, jv_ = jax_paths(jo.m), jax_paths(jo.v)
        tm_, tv_ = torch_paths(to.m), torch_paths(to.v)
        jnew = jax_paths(jp)
        for path, t in torch_paths(tp).items():
            close(tm_[path], jm_[path], TOL, f"step {step} m {path}")
            close(tv_[path], jv_[path], TOL, f"step {step} v {path}")
            m = np.abs(jm_[path])
            live = m > 1e-2 * np.sqrt(np.mean(m ** 2))
            close(t - tprev[path], jnew[path] - jprev[path], TOL,
                  f"step {step} update {path}", mask=live)
        if step == 0:                 # warmup 1: the first lr is 0
            assert float(tmet["lr"]) == 0.0
            for path, t in torch_paths(tp).items():
                torch.testing.assert_close(t, tprev[path], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the partition runtime (as tests/test_substrate.py holds the reference's)
# ---------------------------------------------------------------------------


def _mk_runtime(partitions=2, sync_every=2):
    cfg = get_config("qwen2_7b", smoke=True)
    api = tapi.build(cfg, "cpu")
    pc = TP.PartitionConfig(partitions=partitions, sync_every=sync_every)
    step = TRS.make_train_step(api, peak_lr=5e-3, warmup=2, total=60)
    rt = PartitionRuntime(api, step, pc, torch.Generator().manual_seed(0))
    shape = ShapeCell("train", 64, 2 * partitions, "train")

    def make_batches(step):
        b = TDATA.synth_lm_batch(cfg, shape, step, partitions=partitions)
        return [{k: v[i] for k, v in b.items()} for i in range(partitions)]

    return rt, make_batches


def test_partitions_diverge_then_sync():
    rt, mb = _mk_runtime(2, sync_every=4)
    for s in range(3):
        rt.run_round(mb(s))
        assert not rt.maybe_sync()
    w0, w1 = leaves(rt.parts[0].params)[0], leaves(rt.parts[1].params)[0]
    assert not torch.allclose(w0.float(), w1.float())
    rt.run_round(mb(3))
    assert rt.maybe_sync()            # the 4th step triggers the sync
    assert rt.sync_count == 1
    for a, b in zip(leaves(rt.parts[0].params), leaves(rt.parts[1].params)):
        assert torch.equal(a, b)
    assert rt.parts[0].last_sync_step == rt.parts[1].last_sync_step == 4


def test_partition_failure_and_replacement():
    rt, mb = _mk_runtime(3, sync_every=2)
    rt.global_batch = 6
    losses = rt.train(lambda s: mb(s), 4, fail_at={1: 2})
    assert len(rt.alive_parts()) == 2
    assert rt.accum == 2              # 3 -> 2 partitions: accum rescaled
    assert all(np.isfinite(list(l.values())).all() for l in losses)
    assert set(losses[0]) == {0, 1, 2} and set(losses[-1]) == {0, 1}
    rt.add_partition(2)
    assert len(rt.alive_parts()) == 3 and rt.accum == 1
    for a, b in zip(leaves(rt.parts[2].params), leaves(rt.parts[0].params)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    rt.run_round(mb(9))
    rt.sync()


def test_training_reduces_loss_partitioned():
    rt, mb = _mk_runtime(2, sync_every=2)
    losses = rt.train(lambda s: mb(s % 4), 14)
    first = np.mean(list(losses[0].values()))
    last = np.mean([np.mean(list(l.values())) for l in losses[-3:]])
    assert last < first               # synthetic Zipf data is learnable


def test_checkpoint_resume_exact(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
    cfg = get_config("mamba2_130m", smoke=True)
    api = tapi.build(cfg, "cpu")
    shape = SMOKE_SHAPES["train_4k"]
    step_fn = TRS.make_train_step(api)

    def run(params, opt, start, n):
        for s in range(start, start + n):
            params, opt, m = step_fn(params, opt,
                                     TDATA.synth_lm_batch(cfg, shape, s))
        return params, opt, m

    def init():
        return api.init(torch.Generator().manual_seed(0))

    p0 = init()
    pa, oa, ma = run(p0, TADAM.adamw_init(p0), 0, 6)
    p1 = init()
    p1, o1, _ = run(p1, TADAM.adamw_init(p1), 0, 3)
    cm = CheckpointManager(tmp_path)
    cm.save(3, {"params": p1, "opt": o1._asdict()})
    tmpl = init()
    to = TADAM.adamw_init(tmpl)
    st, meta = cm.restore({"params": tmpl, "opt": to._asdict()})
    o1r = to._replace(**{k: st["opt"][k] for k in ("step", "m", "v")})
    pb, ob, mb = run(st["params"], o1r, 3, 3)
    assert meta["step"] == 3
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(leaves(pa), leaves(pb)):
        assert torch.equal(a, b)


def test_train_cli_end_to_end(tmp_path):
    """The CLI: partitioned with failure injection (as the reference's
    ``tests/test_system.py`` drives its train CLI), then the synchronous path
    and its resume."""
    from repro_torch.launch.train import main
    losses = main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                   "--steps", "8", "--partitions", "2", "--sync-every", "2",
                   "--ckpt-dir", str(tmp_path), "--fail-at", "5:1"])
    assert len(losses) == 8
    assert set(losses[-1].keys()) == {0}
    assert np.isfinite(list(losses[-1].values())).all()
    sync_dir = tmp_path / "sync"
    args = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(sync_dir), "--accum", "2"]
    straight = main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path / "s")])
    first = main(args + ["--steps", "2"])
    resumed = main(args + ["--steps", "1", "--resume"])
    assert first + resumed == straight
    assert CheckpointManager(sync_dir / "qwen2_7b").steps() == [2, 3]
