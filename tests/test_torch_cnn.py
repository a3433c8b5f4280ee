"""The port's CNN path (``repro_torch.models.cnn``) against the JAX package.

* ``model_traces`` of VGG-16, GoogLeNet and ResNet-50 equal the
  reference's field for field, exactly (they feed the paper's simulator).
* ``init_cnn`` gives the reference's shapes, op for op and key for key.
* Max pooling pads SAME with -inf as ``lax.reduce_window`` does, also on an
  even input under a 3x3 stride-2 window, where the pad is (0, 1).
* Tiny ResNet-, inception- and VGG-like nets, built from the op
  constructors and registered into BOTH packages' ``CNN_OPS`` (nothing in
  ``src/repro`` is edited), run through the reference's ``apply_cnn``
  (``"xla"`` and ``"pallas"`` in interpret mode) and through the port on
  the same carried weights; and full-depth ResNet-50 at img 32 against the
  reference's ``"xla"`` forward.  Gate: max abs err <= 2e-4 * max|ref| in
  fp32 (activations grow through unnormalised residual adds, so the gate
  is relative to the output's scale) and identical argmax per image.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_jax
from repro_torch.models import cnn

NETS = ("vgg16", "googlenet", "resnet50")
REL = 2e-4


# ---------------------------------------------------------------------------
# traces and shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NETS)
def test_model_traces_equal_reference(name):
    ours, ref = cnn.model_traces(name), jcnn.model_traces(name)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    small = cnn.model_traces(name, img=64)
    assert [dataclasses.astuple(t) for t in small] == \
        [dataclasses.astuple(t) for t in jcnn.model_traces(name, img=64)]


@pytest.mark.parametrize("name", NETS)
def test_op_tables_equal_reference(name):
    assert cnn.CNN_OPS[name]() == jcnn.CNN_OPS[name]()
    assert cnn.CNN_INPUT[name] == jcnn.CNN_INPUT[name]


@pytest.mark.parametrize("name", NETS)
def test_init_cnn_shapes_equal_reference(name):
    ref = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), name,
                                               img=32))
    ours = cnn.init_cnn(torch.Generator().manual_seed(0), name, img=32,
                        device="cpu")
    assert len(ours) == len(ref)
    for p, r in zip(ours, ref):
        assert sorted(p) == sorted(r)
        for k in p:
            assert tuple(p[k].shape) == tuple(r[k].shape)
            assert p[k].dtype == torch.float32 and p[k].device.type == "cpu"


def test_init_cnn_one_seed_same_weights_and_he_scale():
    a = cnn.init_cnn(torch.Generator().manual_seed(3), "resnet50", img=32,
                     device="cpu")
    b = cnn.init_cnn(torch.Generator().manual_seed(3), "resnet50", img=32,
                     device="cpu")
    for p, q in zip(a, b):
        for k in p:
            assert torch.equal(p[k], q[k])
    assert a[-2] == {}             # gap
    w = a[-3]["cout"]              # last block's 1x1 expansion: 512 -> 2048
    assert w.shape == (1, 1, 512, 2048)
    assert abs(float(w.std()) / np.sqrt(2.0 / 512) - 1) < 0.02
    fc = a[-1]["w"]
    assert abs(float(fc.std()) / np.sqrt(1.0 / 2048) - 1) < 0.02
    assert torch.equal(a[0]["scale"], torch.ones(64))
    assert torch.equal(a[-1]["b"], torch.zeros(1000))


def test_bridge_carries_a_list_of_dicts():
    tree = [{"w": np.ones((2, 3), np.float32)}, {}, ({"b": np.zeros(4)},)]
    out = params_from_jax(tree, device="cpu")
    assert isinstance(out, list) and out[1] == {}
    assert isinstance(out[2], tuple)
    assert torch.equal(out[0]["w"], torch.ones((2, 3)))
    assert out[2][0]["b"].shape == (4,)


# ---------------------------------------------------------------------------
# max pooling: SAME with -inf, asymmetric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,s", [(16, 3, 2), (112, 3, 2), (15, 3, 2),
                                      (8, 3, 1), (9, 2, 2)])
def test_max_pool_same_matches_reduce_window(size, k, s):
    rng = np.random.default_rng(size * k + s)
    x = rng.standard_normal((2, size, size, 5), np.float32) - 3.0
    ref = lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max,
                            (1, k, k, 1), (1, s, s, 1), "SAME")
    out = cnn.max_pool_same(torch.from_numpy(x), k, s)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_symmetric_max_pool_padding_would_shift_windows():
    """F.max_pool2d(padding=1) on an even input gives the reference's shape
    but windows shifted by one row and column: the hazard the -inf pad
    avoids."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 16, 4), np.float32))
    ours = cnn.max_pool_same(x, 3, 2)
    shifted = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
    shifted = shifted.permute(0, 2, 3, 1)
    assert ours.shape == shifted.shape == (1, 8, 8, 4)
    assert not torch.equal(ours, shifted)


# ---------------------------------------------------------------------------
# forward passes on carried weights
# ---------------------------------------------------------------------------

c, mp, fc, inc, rb = cnn._c, cnn._mp, cnn._fc, cnn._inc, cnn._rb
TINY = {  # name: (ops, img)
    "tiny_resnet": ([c(8, 7, 2), mp(3, 2), rb(4, 4, 16, s=1, proj=True),
                     rb(4, 4, 16), rb(8, 8, 32, s=2, proj=True), rb(8, 8, 32),
                     {"kind": "gap"}, fc(10, relu=False)], 32),
    "tiny_inception": ([c(8, 7, 2), mp(), c(8, 1), c(16, 3), mp(),
                        inc(4, 4, 8, 2, 4, 4), inc(8, 4, 8, 3, 6, 4), mp(),
                        inc(8, 8, 12, 4, 4, 4), {"kind": "gap"},
                        fc(10, relu=False)], 32),
    "tiny_vgg": ([c(8, 3), c(8, 3), mp(2, 2), c(16, 3), mp(2, 2), c(16, 3),
                  mp(2, 2), {"kind": "flatten"}, fc(32), fc(10, relu=False)],
                 18),     # 18 -> 9 -> 5 (the pool pads (0, 1) on 9) -> 3
}


def _gate(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    got = out.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= REL * scale, f"max abs err {err} > {REL} * {scale}"
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _numpy_params(name, img, rng):
    """Weights of the reference's shapes (``jax.eval_shape`` of its
    ``init_cnn``, which compiles nothing) drawn with numpy: He-scaled
    convs and fcs, and non-trivial BN scale / shift and fc bias so that
    every parameter reaches the output."""
    shapes = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0),
                                                  name, img=img))
    out = []
    for p in shapes:
        q = {}
        for k, sd in p.items():
            shape = tuple(sd.shape)
            z = rng.standard_normal(shape).astype(np.float32)
            if k == "scale":
                q[k] = 1 + 0.1 * z
            elif k in ("shift", "b"):
                q[k] = 0.1 * z
            elif len(shape) == 2:                   # fc (cin, cout)
                q[k] = z * np.float32(np.sqrt(1.0 / shape[0]))
            else:                                   # conv (k, k, cin, cout)
                q[k] = z * np.float32(np.sqrt(2.0 / np.prod(shape[:3])))
        out.append(q)
    return out


@pytest.fixture(scope="module")
def tiny_nets():
    """Each tiny net registered into both packages, with weights and an
    input made with numpy."""
    mp_ = pytest.MonkeyPatch()
    nets = {}
    for i, (name, (ops, img)) in enumerate(TINY.items()):
        mp_.setitem(cnn.CNN_OPS, name, lambda ops=ops: [dict(o) for o in ops])
        mp_.setitem(jcnn.CNN_OPS, name, lambda ops=ops: [dict(o) for o in ops])
        rng = np.random.default_rng(i)
        params = _numpy_params(name, img, rng)
        x = rng.standard_normal((4, img, img, 3), np.float32)
        nets[name] = (params, x)
    yield nets
    mp_.undo()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_net_forward_matches_reference(tiny_nets, name, impl):
    params, x = tiny_nets[name]
    ref = jcnn.apply_cnn(jax.tree.map(jnp.asarray, params), name,
                         jnp.asarray(x), conv_impl=impl)
    tparams = params_from_jax(params, device="cpu")
    out = cnn.apply_cnn(tparams, name, torch.from_numpy(x))
    assert out.shape == (4, 10)
    _gate(out, ref)


@pytest.fixture(scope="module")
def resnet50_img32():
    params = jcnn.init_cnn(jax.random.PRNGKey(0), "resnet50", img=32)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3), np.float32)
    return params, x


def test_resnet50_full_depth_matches_reference(resnet50_img32):
    params, x = resnet50_img32
    ref = jax.jit(lambda p, x: jcnn.apply_cnn(p, "resnet50", x))(
        params, jnp.asarray(x))
    out = cnn.apply_cnn(params_from_jax(params, device="cpu"), "resnet50",
                        torch.from_numpy(x))
    assert out.shape == (2, 1000)
    _gate(out, ref)


def test_resnet50_runs_the_conv_and_matmul_wrappers(resnet50_img32,
                                                    monkeypatch):
    """Every conv goes through ``kernels.conv2d.ops.conv2d`` (53) and the
    fc through ``kernels.matmul.ops.matmul`` (1)."""
    params, x = resnet50_img32
    calls = {"conv": 0, "mm": 0}
    conv, mm = cnn.conv2d, cnn.matmul

    def counting_conv(*a, **k):
        calls["conv"] += 1
        return conv(*a, **k)

    def counting_mm(*a, **k):
        calls["mm"] += 1
        return mm(*a, **k)
    monkeypatch.setattr(cnn, "conv2d", counting_conv)
    monkeypatch.setattr(cnn, "matmul", counting_mm)
    cnn.apply_cnn(params_from_jax(params, device="cpu"), "resnet50",
                  torch.from_numpy(x[:1]))
    assert calls == {"conv": 53, "mm": 1}
