"""The port's training forward and loss against the JAX reference: the
dense (qwen2-7b), MoE (qwen3-moe, the router's aux term included) and VLM
(internvl2, the image prefix) families at the smoke size, on the
reference's weights (``bridge.params_from_jax``) and the same
``synth_lm_batch``: the loss and its metrics, the gradient of every
parameter (``jax.value_and_grad`` of the reference's ``loss_fn`` against
``torch.autograd.grad`` of the port's) and ``forward_lm``'s logits, in fp32
and bf16 (tolerances in ``_torch_train_common.py``); ``chunked_ce`` at a
prime length (chunks of 1), at a chunk that does not divide S and at one
longer than S; the remat modes.  The SSM, hybrid and enc-dec families are
in ``test_torch_train_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import (TOL, build_case, check_forward,
                                 check_gradients, check_loss, close)

from repro.configs import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.models import transformer as JTF
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synth_lm_batch
from repro_torch.models import transformer as TF
from repro_torch.tree import leaves_with_paths

ARCHS = ["qwen2-7b", "qwen3-moe-30b-a3b", "internvl2-26b"]


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return build_case(*request.param)


def test_loss_and_metrics(case):
    check_loss(case)


def test_every_gradient(case):
    check_gradients(case)


def test_forward_logits(case):
    check_forward(case)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S,chunk", [(13, 8), (12, 5), (16, 4), (7, 512)])
def test_chunked_ce(dtype, S, chunk):
    """The chunk rule (c = min(chunk, S), lowered until it divides S) and
    the recomputed chunks' gradients, x and head both."""
    rng = np.random.default_rng(S * 31 + chunk)
    B, d, V = 2, 16, 40
    x = rng.standard_normal((B, S, d), np.float32)
    head = rng.standard_normal((d, V), np.float32) * 0.3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jf(x, head):
        return JTF.chunked_ce(x, head, jnp.asarray(labels), jnp.asarray(mask),
                              chunk)

    jv, (jgx, jgh) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x).astype(jdt), jnp.asarray(head).astype(jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    th = torch.from_numpy(head).to(tdt).requires_grad_(True)
    tv = TF.chunked_ce(tx, th, torch.from_numpy(labels),
                       torch.from_numpy(mask), chunk)
    tgx, tgh = torch.autograd.grad(tv, (tx, th))
    tol = TOL[dtype]
    close(tv, jv, tol, "nll")
    close(tgx, jgx, tol, "dx")
    close(tgh, jgh, tol, "dhead")


def test_remat_modes():
    """"none" and "full" give the same loss and gradients (the recompute
    reruns the same arithmetic); "dots" raises with its reason."""
    cfg = get_config("qwen2-7b", smoke=True).replace(dtype="float32")
    b = synth_lm_batch(cfg, JSMOKE_SHAPES["train_4k"], 0)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    out = {}
    for remat in ("full", "none"):
        c = cfg.replace(remat=remat)
        p = TF.init_lm(c, torch.Generator().manual_seed(0), "cpu")
        flat = [t.requires_grad_(True) for _, t in leaves_with_paths(p)]
        loss, _ = TF.loss_fn(p, c, tb)
        out[remat] = (loss, torch.autograd.grad(loss, flat))
    torch.testing.assert_close(out["full"][0], out["none"][0], rtol=0, atol=0)
    for a, b_ in zip(out["full"][1], out["none"][1]):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    c = cfg.replace(remat="dots")
    p = TF.init_lm(c, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="dots_with_no_batch_dims"):
        TF.loss_fn(p, c, tb)
