"""Shared helpers of the training-path model tests
(``test_torch_train_model.py``, ``test_torch_train_families.py``): build
one family's case at the smoke size on the reference's weights, and the
comparisons.

fp32 is held at 2e-4 and bf16 at 3e-2, each against the RMS of the JAX
value: |port - jax| <= tol * (rms(jax) + |jax|), element by element.  A
bf16 gradient or logit tensor is held by its norm instead, ||port - jax||
<= 3e-2 ||jax||: the two packages round to bf16 at different points of
the model (each product's output, each cast), and over a model's sums of
hundreds of such terms single elements land 2-15x outside the
element-wise bound while each whole tensor agrees within 2.1 %.  A key
bias without rotary positions (whisper's) has a gradient of exactly 0 in
exact arithmetic (the softmax ignores a shift common to all keys): both
packages' are rounding noise, so each is held below tol x the RMS of the
same layer's query-bias gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.models import api as tapi
from repro_torch.tree import leaves_with_paths

TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def close(got, want, tol, what="", mask=None):
    """Element by element; with ``mask``, only the entries it marks."""
    got = np.asarray(got.detach().float().numpy(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    lim = tol * (rms + np.abs(want))
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if mask is not None:
        err, lim = err[mask], lim[mask]
    assert (err <= lim).all(), (
        f"{what}: max err {err.max():.3g}, worst {(err / lim).max():.3g} x "
        f"the limit (rms {rms:.3g})")


def close_model(got, want, dtype, what):
    """fp32 element by element; bf16 by the tensor's norm."""
    if dtype == "float32":
        return close(got, want, TOL[dtype], what)
    got = np.asarray(got.detach().float().numpy(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= TOL[dtype], f"{what}: relative L2 error {err:.3g}"


def jax_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def build_case(arch, dtype):
    """Both packages' loss, metrics and every gradient on the reference's
    weights and one ``synth_lm_batch`` (step 3, the smoke train cell)."""
    jcfg = jget_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
    b = synth_lm_batch(tcfg, JSMOKE_SHAPES["train_4k"], 3)
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jb)
    tm = tapi.build(tcfg, "cpu")
    tp = params_from_jax(jp, "cpu")
    flat = [t.requires_grad_(True) for _, t in leaves_with_paths(tp)]
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    tloss, tmet = tm.loss(tp, tb)
    tgrads = torch.autograd.grad(tloss, flat)
    return dict(dtype=dtype, jloss=jloss, jmet=jmet, jgrads=jgrads,
                tloss=tloss, tmet=tmet, tp=tp, tgrads=tgrads, jm=jm, jp=jp,
                jb=jb, tm=tm, tb=tb, tcfg=tcfg)


def check_loss(case):
    tol = TOL[case["dtype"]]
    close(case["tloss"], case["jloss"], tol, "loss")
    for k, v in case["jmet"].items():
        close(case["tmet"][k], v, tol, k)
    assert set(case["tmet"]) == set(case["jmet"])


def check_gradients(case):
    tol = TOL[case["dtype"]]
    want = jax_paths(case["jgrads"])
    got = dict(zip((p for p, _ in leaves_with_paths(case["tp"])),
                   case["tgrads"]))
    assert set(got) == set(want)
    for path, g in got.items():
        assert str(g.dtype).replace("torch.", "") == str(want[path].dtype)
        if path.endswith("/bk") and not case["tcfg"].rope_theta:
            scale = tol * float(got[path[:-2] + "bq"].float().pow(2).mean()
                                .sqrt())
            assert float(g.abs().max()) <= scale, path
            assert float(np.abs(np.asarray(want[path], np.float32)).max()) \
                <= scale, path
            continue
        close_model(g, want[path], case["dtype"], path)


def check_forward(case):
    jl, jaux = jax.jit(case["jm"].forward)(case["jp"], case["jb"])
    with torch.no_grad():
        tl, taux = case["tm"].forward(case["tp"], case["tb"])
    assert tl.dtype == torch.float32
    close_model(tl, jl, case["dtype"], "logits")
    close(taux, jaux, TOL[case["dtype"]], "aux")
