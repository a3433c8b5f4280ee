"""The train step through ``runtime/train_graph.TrainGraph``, the port's
counterpart of the reference's jitted step.

On a card each replica's step runs eagerly at its first call, is captured
as a CUDA graph at its second and replayed after that; on the CPU every
call runs the same static-buffer path eagerly.  ``Emulated`` below gives
the CPU the card's lifecycle: its stand-in graph's capture runs the step
once, as a capture's pass issues it, and puts the replica's state back (a
capture computes nothing), and each replay runs the step again and writes
the capture's output tensors in place, as a replay does, leaving the
wrappers' counts as they were (a replay issues nothing through them).

* The wrapped step against the unwrapped one, bit for bit over 3 steps
  (losses, every metric, params, m, v, the step counter, the learning
  rate; warmup 2, so the rate moves), for the dense, MoE, VLM, SSM,
  hybrid and enc-dec smoke configs at accum 1 and 2, on the static path
  and emulated; the partitioned step too.
* The dense smoke config, 2 steps through the emulated graph, against
  ``jax.jit(make_train_step(api))`` within 2e-4 (fp32, element by
  element; each step's update where m is above 1 % of its RMS, as
  ``tests/test_torch_train_runtime.py`` holds the unwrapped step).
* The lifecycle: eager, capture, replays with the counter and the rate
  advancing; a second replica's params get a graph of their own; a batch
  of another layout raises; a step that does not update in place raises.
* ``PartitionRuntime`` (P = 2, a partition dropped, one added) bit for
  bit against the same runtime on the unwrapped step.
* What a graphed run issues through the wrappers: ``train_issues`` of
  ``issued_steps`` steps (the eager one and the capture).
"""
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import close
from repro.configs import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.optim import adamw as JADAM
from repro.runtime import steps as JRS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import SMOKE_SHAPES, ShapeCell
from repro_torch.core.partitioning import PartitionConfig
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.launch import train
from repro_torch.models import api as tapi
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.profiling import train_counts as TC
from repro_torch.runtime import steps as RS
from repro_torch.runtime.partition_runtime import PartitionRuntime
from repro_torch.runtime.train_graph import ReplicaStep, TrainGraph
from repro_torch.tree import leaves, leaves_with_paths, tree_map

ARCHS = ["qwen2-7b", "qwen3-moe-30b-a3b", "internvl2-26b", "mamba2-130m",
         "hymba-1.5b", "whisper-base"]
KW = dict(peak_lr=1e-2, warmup=2, total=50)
N_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps here are many small CPU ops: one intra-op thread keeps
    each from waiting at a thread barrier when the test workers share the
    cores with other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Graph:
    """A stand-in CUDA graph (see the module's docstring); ``quiet``: a
    Counter of launches a replay must leave as it found it."""

    def __init__(self, run, state, quiet):
        params, opt = state
        self.tensors = (leaves(params) + leaves(opt.m) + leaves(opt.v)
                        + [opt.step])
        saved = [t.clone() for t in self.tensors]
        self.run, self.quiet = run, quiet
        self.out = run()
        for t, s in zip(self.tensors, saved):
            t.copy_(s)

    def replay(self):
        before = Counter(self.quiet or {})
        new = self.run()
        for k, t in self.out.items():
            t.copy_(new[k])
        if self.quiet is not None:
            self.quiet.clear()
            self.quiet.update(before)


class _EmulatedStep(ReplicaStep):
    quiet = None

    def __init__(self, *args):
        super().__init__(*args)
        self.on_card = True

    def _record(self):
        g = _Graph(lambda: self._step(*self.buffers), self.state, self.quiet)
        return g, g.out


class Emulated(TrainGraph):
    """The card's lifecycle on the CPU: eager step, capture, replays."""

    op_type = _EmulatedStep


def _init(api, seed=0):
    params = api.init(torch.Generator().manual_seed(seed))
    return params, adamw_init(params)


def _state(params, opt):
    return {**{f"p/{k}": v for k, v in leaves_with_paths(params)},
            **{f"m/{k}": v for k, v in leaves_with_paths(opt.m)},
            **{f"v/{k}": v for k, v in leaves_with_paths(opt.v)},
            "step": opt.step}


def _run(step, api, cfg, n=N_STEPS, seed=0):
    params, opt = _init(api, seed)
    metrics = []
    for s in range(n):
        params, opt, m = step(params, opt, synth_lm_batch(
            cfg, SMOKE_SHAPES["train_4k"], s))
        metrics.append(m)
    return _state(params, opt), metrics


def _equal(got, want):
    """(state, metrics of every step) bit for bit."""
    (gs, gm), (ws, wm) = got, want
    assert set(gs) == set(ws)
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k
    assert len(gm) == len(wm)
    for s, (a, b) in enumerate(zip(gm, wm)):
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), (s, k)


@pytest.mark.parametrize("mode", ["static", "emulated"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_wrapped_step_equals_unwrapped(arch, accum, mode):
    cfg = get_config(arch, smoke=True)
    api = tapi.build(cfg, "cpu")
    step = RS.make_train_step(api, accum=accum, **KW)
    graph = (Emulated if mode == "emulated" else TrainGraph)(step, "cpu")
    got = _run(graph, api, cfg)
    _equal(got, _run(step, api, cfg))
    assert int(got[0]["step"]) == N_STEPS
    lrs = [float(m["lr"]) for m in got[1]]
    assert lrs[0] == 0.0 and lrs[0] < lrs[1] < lrs[2] == float(
        np.float32(KW["peak_lr"]))
    (op,) = graph.ops.values()
    if mode == "emulated":
        assert (op.n_eager, op.n_replays, op.last) == (1, 2, "replay")
    else:
        assert (op.n_eager, op.n_replays, op.last) == (N_STEPS, 0, "eager")


@pytest.mark.parametrize("mode", ["static", "emulated"])
def test_wrapped_partitioned_step_equals_unwrapped(mode):
    """``make_partitioned_train_step`` on stacked (2, ...) state: views of
    the stacked tensors inside, one graph for the stack."""
    cfg = get_config("qwen2-7b", smoke=True)
    api = tapi.build(cfg, "cpu")
    step = RS.make_partitioned_train_step(api, **KW)
    graph = (Emulated if mode == "emulated" else TrainGraph)(step, "cpu")

    def run(fn):
        stacked = tree_map(lambda *xs: torch.stack(xs),
                           *(_init(api, i)[0] for i in range(2)))
        opt = adamw_init(stacked)
        opt = AdamWState(torch.zeros((2,), dtype=torch.int32), opt.m, opt.v)
        metrics = []
        for s in range(N_STEPS):
            b = synth_lm_batch(cfg, SMOKE_SHAPES["train_4k"], s,
                               partitions=2)
            stacked, opt, m = fn(stacked, opt, b)
            metrics.append(m)
        return _state(stacked, opt), metrics

    got = run(graph)
    _equal(got, run(step))
    assert got[0]["step"].tolist() == [N_STEPS] * 2 and len(graph.ops) == 1


def test_emulated_graph_against_jax_reference():
    jcfg = jget_config("qwen2-7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    kw = dict(peak_lr=1e-2, warmup=1, total=50)
    jstep = jax.jit(JRS.make_train_step(jm, **kw))
    tm = tapi.build(tcfg, "cpu")
    graph = Emulated(RS.make_train_step(tm, **kw), "cpu")
    tp = params_from_jax(jp, "cpu")
    jo, to = JADAM.adamw_init(jp), adamw_init(tp)
    for step in range(2):
        b = synth_lm_batch(tcfg, JSMOKE_SHAPES["train_4k"], step)
        jprev = {k: np.asarray(v) for k, v in _jpaths(jp).items()}
        tprev = {k: v.clone() for k, v in leaves_with_paths(tp)}
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = graph(tp, to, b)
        assert set(tmet) == set(jmet)
        for k in jmet:
            close(tmet[k], jmet[k], 2e-4, f"step {step} {k}")
        assert int(to.step) == int(jo.step) == step + 1
        jm_, jv_, jnew = _jpaths(jo.m), _jpaths(jo.v), _jpaths(jp)
        tm_, tv_ = dict(leaves_with_paths(to.m)), dict(leaves_with_paths(to.v))
        for path, t in leaves_with_paths(tp):
            close(tm_[path], jm_[path], 2e-4, f"step {step} m {path}")
            close(tv_[path], jv_[path], 2e-4, f"step {step} v {path}")
            m = np.abs(np.asarray(jm_[path]))
            live = m > 1e-2 * np.sqrt(np.mean(m ** 2))
            close(t - tprev[path], np.asarray(jnew[path]) - jprev[path],
                  2e-4, f"step {step} update {path}", mask=live)
    (op,) = graph.ops.values()
    assert (op.n_eager, op.n_replays, op.last) == (1, 1, "capture")


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_lifecycle_replicas_and_layout():
    cfg = get_config("mamba2-130m", smoke=True)
    api = tapi.build(cfg, "cpu")
    step = RS.make_train_step(api, **KW)
    graph = Emulated(step, "cpu")
    params, opt = _init(api)
    counter = opt.step
    shape = SMOKE_SHAPES["train_4k"]
    want = _run(step, api, cfg, n=4)[1]
    kinds = []
    for s in range(4):
        params, opt, m = graph(params, opt, synth_lm_batch(cfg, shape, s))
        (op,) = graph.ops.values()
        kinds.append(op.last)
        assert opt.step is counter and int(counter) == s + 1
        assert torch.equal(m["lr"], want[s]["lr"])
        assert torch.equal(m["loss"], want[s]["loss"])
    assert kinds == ["eager", "capture", "replay", "replay"]
    # the returned metrics are copies: a later replay leaves them alone
    assert m["loss"] is not op.out["loss"]

    # a second replica: its own graph, its own lifecycle
    other, oopt = _init(api, seed=1)
    for s in range(2):
        other, oopt, _ = graph(other, oopt, synth_lm_batch(cfg, shape, s))
    assert len(graph.ops) == 2
    assert [o.last for o in graph.ops.values()] == ["replay", "capture"]
    assert int(oopt.step) == 2 and int(opt.step) == 4
    stats = graph.stats()
    assert (stats["replicas"], stats["eager"], stats["replays"]) == (2, 2, 4)

    b = synth_lm_batch(cfg, ShapeCell("train", 32, 4, "train"), 0)
    with pytest.raises(ValueError, match="layout"):
        graph(params, opt, b)
    b = synth_lm_batch(cfg, shape, 0)
    with pytest.raises(ValueError, match="layout"):
        graph(params, opt, {**b, "mask": np.ones(b["labels"].shape,
                                                  np.float32)})
    with pytest.raises(ValueError, match="layout"):
        graph(params, opt, {k: v.astype(np.int64) for k, v in b.items()})

    def not_in_place(params, opt_state, batch):
        _, st, m = step(params, opt_state, batch)
        return tree_map(torch.clone, params), st, m

    with pytest.raises(ValueError, match="in place"):
        TrainGraph(not_in_place, "cpu")(params, opt, b)


def test_partition_runtime_bitwise_against_eager_runtime():
    cfg = get_config("qwen2-7b", smoke=True)
    api = tapi.build(cfg, "cpu")
    pc = PartitionConfig(partitions=2, sync_every=2)
    step = RS.make_train_step(api, **KW)
    shape = ShapeCell("train", 64, 4, "train")

    def make_batches(s):
        b = synth_lm_batch(cfg, shape, s, partitions=2)
        return [{k: v[i] for k, v in b.items()} for i in range(2)]

    def run(graphed):
        rt = PartitionRuntime(api, step, pc, torch.Generator().manual_seed(0))
        if graphed:
            rt.train_step = Emulated(step, "cpu")
        else:
            rt.train_step = rt.train_step.step      # the unwrapped step
        losses = rt.train(make_batches, 4, fail_at={2: 1})
        rt.add_partition(1)
        for s in range(4, 8):
            ms = rt.run_round(make_batches(s))
            losses.append({i: float(m["loss"]) for i, m in ms.items()})
            rt.maybe_sync()
        return rt, losses

    rt, losses = run(True)
    rt0, losses0 = run(False)
    assert losses == losses0 and rt.sync_count == rt0.sync_count == 4
    assert set(losses[3]) == {0} and set(losses[-1]) == {0, 1}
    for p, p0 in zip(rt.parts, rt0.parts):
        a, b = _state(p.params, p.opt_state), _state(p0.params, p0.opt_state)
        for k in b:
            assert torch.equal(a[k], b[k]), k
    # replica 0, the dropped replica 1 (2 steps) and its replacement
    # (4 steps): a graph each
    assert [o.last for o in rt.train_step.ops.values()] == \
        ["replay", "capture", "replay"]


@pytest.fixture
def counting(monkeypatch):
    """The wrappers' plain versions, counting what each wrapper issues (as
    ``tests/test_torch_train_counts.py`` counts them)."""
    n = Counter()

    def mm(a, b):
        n["matmul"] += 1
        return mm_ref.matmul(a, b)

    def lse(*a, **kw):
        n["flash_attention"] += 1
        return fa_ref.attention_lse(*a, **kw)

    def attention(*a, **kw):
        n["flash_attention"] += 1
        return fa_ref.attention(*a, **kw)

    def bwd(*a, **kw):
        n["flash_attention_backward"] += 1
        return fa_ref.attention_backward(*a, **kw)

    monkeypatch.setattr(mm_ops, "ref", types.SimpleNamespace(matmul=mm))
    monkeypatch.setattr(fa_ops, "ref", types.SimpleNamespace(
        attention=attention, attention_lse=lse, attention_backward=bwd))
    monkeypatch.setattr(_EmulatedStep, "quiet", n)
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_run_issues_train_issues(arch, counting):
    cfg = get_config(arch, smoke=True)
    api = tapi.build(cfg, "cpu")
    step = RS.make_train_step(api, accum=2, **KW)
    seq = SMOKE_SHAPES["train_4k"].seq_len
    for fn, graphed in ((Emulated(step, "cpu"), True), (step, False)):
        counting.clear()
        _run(fn, api, cfg, n=4)
        want = TC.train_issues(cfg, seq, 2 * TC.issued_steps(4, graphed))
        assert dict(counting) == {k: v for k, v in want.items() if v}
    assert TC.issued_steps(1) == 1 and TC.issued_steps(4) == 2


def test_train_cli_prints_the_graph(capsys, tmp_path):
    train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                "--steps", "3", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "train graph: 1 replicas, 3 eager steps, 0 replays" in out
