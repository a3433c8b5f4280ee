"""The partitioned train step (``runtime/steps.make_partitioned_train_step``)
against the JAX package's vmapped one, and against P separate steps.

qwen2-7b and mamba2-130m at their ``--smoke`` sizes in fp32, P = 2
partitions with weights of their own (the reference's, drawn from
``PRNGKey(0)`` and ``PRNGKey(1)`` and stacked), two steps with
``warmup=1`` (the first learning rate is 0) on the smoke train cell's
batch split into the partitions' halves:

* losses, metrics, m and v within 2e-4 x (rms + |jax|) element-wise of
  ``jax.jit(make_partitioned_train_step(api))`` (a ``jax.vmap`` with
  ``spmd_axis_name="part"``, run outside a mesh); params the same, where
  the first moment is live (Adam's first updates are ~sign(m) x lr, so a
  moment at rounding noise can take either sign in either package, as
  ``test_torch_train_runtime.py`` holds the single step);
* bit for bit against ``make_train_step`` run on each partition's own
  copy (the loop computes the vmap's function on views of the stacked
  tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.optim import adamw as JADAM
from repro.runtime import steps as JRS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import SMOKE_SHAPES
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.models import api as tapi
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import steps as TRS
from repro_torch.tree import leaves_with_paths, tree_map

TOL = 2e-4
N_PARTS, N_STEPS = 2, 2
KW = dict(peak_lr=1e-2, warmup=1, total=50)


def _close(got, want, what, mask=None):
    got = np.asarray(got.detach().float().numpy(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    lim = TOL * (np.sqrt(np.mean(want ** 2)) + np.abs(want))
    if mask is not None:
        err, lim = err[mask], lim[mask]
    assert (err <= lim).all(), f"{what}: max err {err.max():.3g}"


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batches(cfg):
    """Each step's smoke batch, split into the partitions' halves."""
    shape = SMOKE_SHAPES["train_4k"]
    out = []
    for step in range(N_STEPS):
        b = synth_lm_batch(cfg, shape, step)
        out.append({k: v.reshape((N_PARTS, v.shape[0] // N_PARTS)
                                 + v.shape[1:]) for k, v in b.items()})
    return out


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m"])
def test_partitioned_step_against_jax_and_separate_steps(arch):
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    jm = japi.build(jcfg)
    parts = [jm.init(jax.random.PRNGKey(i)) for i in range(N_PARTS)]
    jp = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    jo = JADAM.adamw_init(parts[0])
    jo = jax.tree.map(lambda x: jnp.stack([x] * N_PARTS), jo)
    jstep = jax.jit(JRS.make_partitioned_train_step(jm, stack_axis="part",
                                                    **KW))

    tm = tapi.build(tcfg, "cpu")
    tp = params_from_jax(jp, "cpu")
    to = adamw_init(tp)
    to = AdamWState(torch.zeros((N_PARTS,), dtype=torch.int32), to.m, to.v)
    tstep = TRS.make_partitioned_train_step(tm, stack_axis="part", **KW)
    # each partition's own copy, for the separate steps
    own = [(tree_map(lambda x: x[i].clone(), tp), adamw_init(
        tree_map(lambda x: x[i], tp))) for i in range(N_PARTS)]
    base = TRS.make_train_step(tm, **KW)

    for step, b in enumerate(_batches(tcfg)):
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        ret = tstep(tp, to, b)
        assert ret[0] is tp          # updated in place
        tp, to, tmet = ret
        assert set(tmet) == set(jmet)
        for k in jmet:
            assert tuple(tmet[k].shape) == (N_PARTS,), k
            _close(tmet[k], jmet[k], f"step {step} {k}")
        assert to.step.tolist() == [step + 1] * N_PARTS
        jm_, jv_, jn = _jpaths(jo.m), _jpaths(jo.v), _jpaths(jp)
        tm_, tv_ = dict(leaves_with_paths(to.m)), dict(leaves_with_paths(to.v))
        for path, t in leaves_with_paths(tp):
            _close(tm_[path], jm_[path], f"step {step} m {path}")
            _close(tv_[path], jv_[path], f"step {step} v {path}")
            m = np.abs(np.asarray(jm_[path]))
            live = m > 1e-2 * np.sqrt(np.mean(m ** 2))
            _close(t, jn[path], f"step {step} params {path}", mask=live)
        # the separate steps: bit for bit
        for i, (p_i, o_i) in enumerate(own):
            p_i, o_i, m_i = base(p_i, o_i, {k: v[i] for k, v in b.items()})
            own[i] = (p_i, o_i)
            for k, v in m_i.items():
                assert torch.equal(torch.as_tensor(v), tmet[k][i]), k
            assert torch.equal(o_i.step, to.step[i])
            tpl = dict(leaves_with_paths(tp))
            for path, a in leaves_with_paths(p_i):
                assert torch.equal(a, tpl[path][i]), (step, i, path)
            for path, a in leaves_with_paths(o_i.m):
                assert torch.equal(a, tm_[path][i]), (step, i, "m", path)
            for path, a in leaves_with_paths(o_i.v):
                assert torch.equal(a, tv_[path][i]), (step, i, "v", path)


def test_partitioned_step_then_sync_equals_the_mean():
    cfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    api = tapi.build(cfg, "cpu")
    g = [torch.Generator().manual_seed(i) for i in range(N_PARTS)]
    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *(api.init(gi) for gi in g))
    opt = adamw_init(stacked)
    opt = AdamWState(torch.zeros((N_PARTS,), dtype=torch.int32), opt.m,
                     opt.v)
    step = TRS.make_partitioned_train_step(api, **KW)
    for b in _batches(cfg):
        stacked, opt, _ = step(stacked, opt, b)
    avg, avg_opt = TRS.sync_params(stacked, opt)
    before = dict(leaves_with_paths(stacked))
    for path, a in leaves_with_paths(avg):
        x = before[path]
        want = x.float().mean(0, keepdim=True).expand(x.shape).to(x.dtype)
        assert torch.equal(a, want), path
        assert not torch.equal(x[0], x[1]), path     # the partitions differ
    assert torch.equal(avg_opt.step, opt.step)
