"""The paper's CNNs in PyTorch: VGG-16, GoogLeNet (Inception-v1), ResNet-50.

The port's copy of the reference's ``repro/models/cnn.py``.  Each network
is a list of *ops*; the same list is (a) flattened into per-layer
``LayerTrace`` records (FLOPs + memory bytes) that feed the
statistical-traffic-shaping simulator (``repro_torch.core.shaping_sim``),
copied unchanged so the traces equal the reference's, and (b) interpreted
into a runnable forward pass, NHWC end to end with HWIO weights, as there.

Two operations go through the port's kernel wrappers, which run the
hand-written CUDA kernel on a CUDA tensor and the plain PyTorch version on
a CPU tensor:

* every convolution -> ``kernels.conv2d.ops.conv2d`` (SAME padding);
* every fully connected layer -> ``kernels.matmul.ops.matmul``.

Max pooling pads SAME with -inf exactly as the reference's
``lax.reduce_window`` does (asymmetric: 3x3 stride 2 on 112 pads (0, 1));
``F.max_pool2d(padding=1)`` would give the same shape with every window
shifted.

Public entry points
-------------------
model_traces(name, img=None)                          -> [LayerTrace]
init_cnn(generator, name, img=None, dtype, device)    -> params list
apply_cnn(params, name, x)                            -> logits (B, 1000)
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from repro_torch.core.traffic import LayerTrace
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.conv2d.ops import conv2d, pad_same
from repro_torch.kernels.matmul.ops import matmul

BYTES = 4  # paper runs fp32 Caffe/MKL-DNN


# ---------------------------------------------------------------------------
# op tables
# ---------------------------------------------------------------------------

def _c(cout, k, s=1):
    return {"kind": "conv", "cout": cout, "k": k, "s": s}


def _mp(k=3, s=2):
    return {"kind": "maxpool", "k": k, "s": s}


def _fc(cout, relu=True):
    return {"kind": "fc", "cout": cout, "relu": relu}


def _inc(b1, b3r, b3, b5r, b5, bp):
    return {"kind": "inception", "b1": b1, "b3r": b3r, "b3": b3,
            "b5r": b5r, "b5": b5, "bp": bp}


def _rb(c1, c3, cout, s=1, proj=False):
    return {"kind": "resblock", "c1": c1, "c3": c3, "cout": cout,
            "s": s, "proj": proj}


def vgg16_ops():
    ops = []
    for cfgs in ([64, 64], [128, 128], [256, 256, 256],
                 [512, 512, 512], [512, 512, 512]):
        ops += [_c(c, 3) for c in cfgs]
        ops.append(_mp(2, 2))
    ops += [{"kind": "flatten"}, _fc(4096), _fc(4096), _fc(1000, relu=False)]
    return ops


def resnet50_ops():
    ops = [_c(64, 7, 2), _mp(3, 2)]
    stages = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2),
              (512, 2048, 3, 2)]
    for cin, cout, n, s in stages:
        ops.append(_rb(cin, cin, cout, s=s, proj=True))
        ops += [_rb(cin, cin, cout) for _ in range(n - 1)]
    ops += [{"kind": "gap"}, _fc(1000, relu=False)]
    return ops


def googlenet_ops():
    return [
        _c(64, 7, 2), _mp(), _c(64, 1), _c(192, 3), _mp(),
        _inc(64, 96, 128, 16, 32, 32),      # 3a
        _inc(128, 128, 192, 32, 96, 64),    # 3b
        _mp(),
        _inc(192, 96, 208, 16, 48, 64),     # 4a
        _inc(160, 112, 224, 24, 64, 64),    # 4b
        _inc(128, 128, 256, 24, 64, 64),    # 4c
        _inc(112, 144, 288, 32, 64, 64),    # 4d
        _inc(256, 160, 320, 32, 128, 128),  # 4e
        _mp(),
        _inc(256, 160, 320, 32, 128, 128),  # 5a
        _inc(384, 192, 384, 48, 128, 128),  # 5b
        {"kind": "gap"}, _fc(1000, relu=False),
    ]


CNN_OPS = {"vgg16": vgg16_ops, "resnet50": resnet50_ops,
           "googlenet": googlenet_ops}
CNN_INPUT = {"vgg16": 224, "resnet50": 224, "googlenet": 224}


# ---------------------------------------------------------------------------
# per-layer traces (feeds the traffic-shaping simulator)
# ---------------------------------------------------------------------------


def _conv_trace(name, H, W, cin, cout, k, s):
    Ho, Wo = -(-H // s), -(-W // s)
    flops = 2.0 * Ho * Wo * cout * cin * k * k
    wb = cout * cin * k * k * BYTES
    ab = (H * W * cin + Ho * Wo * cout) * BYTES
    return LayerTrace(name, "conv", flops, wb, ab), Ho, Wo


def trace_ops(ops, img=224, include_aux=True, with_bn=True) -> List[LayerTrace]:
    """Flatten an op list into LayerTrace records (order = execution order)."""
    H = W = img
    C = 3
    out: List[LayerTrace] = []

    def aux(name, kind, H, W, C, flo_per_el=1.0):
        if include_aux:
            el = H * W * C
            out.append(LayerTrace(name, kind, flo_per_el * el,
                                  2 * C * BYTES, 2 * el * BYTES))

    def conv(name, cin, cout, k, s, bn=with_bn, relu=True):
        nonlocal H, W
        t, Ho, Wo = _conv_trace(name, H, W, cin, cout, k, s)
        out.append(t)
        H, W = Ho, Wo
        if bn:
            aux(name + ".bn", "bn", H, W, cout, 2.0)
        if relu:
            aux(name + ".relu", "relu", H, W, cout, 1.0)
        return cout

    i = 0
    for op in ops:
        i += 1
        nm = f"op{i}"
        kind = op["kind"]
        if kind == "conv":
            C = conv(nm, C, op["cout"], op["k"], op["s"])
        elif kind == "maxpool":
            el = H * W * C
            out.append(LayerTrace(nm + ".pool", "pool", el * op["k"] ** 2,
                                  0.0, 2 * el * BYTES))
            H, W = -(-H // op["s"]), -(-W // op["s"])
        elif kind == "gap":
            out.append(LayerTrace(nm + ".gap", "pool", H * W * C, 0.0,
                                  (H * W * C + C) * BYTES))
            H = W = 1
        elif kind == "flatten":
            C = H * W * C
            H = W = 1
        elif kind == "fc":
            cin = H * W * C if H > 1 else C
            out.append(LayerTrace(nm + ".fc", "fc", 2.0 * cin * op["cout"],
                                  cin * op["cout"] * BYTES,
                                  (cin + op["cout"]) * BYTES))
            H = W = 1
            C = op["cout"]
        elif kind == "inception":
            cin = C
            Hs, Ws = H, W
            # four parallel branches, concat
            for branch, chain in {
                "b1": [(op["b1"], 1, 1)],
                "b3": [(op["b3r"], 1, 1), (op["b3"], 3, 1)],
                "b5": [(op["b5r"], 1, 1), (op["b5"], 5, 1)],
                "bp": [(op["bp"], 1, 1)],
            }.items():
                H, W = Hs, Ws
                c = cin
                if branch == "bp":
                    el = Hs * Ws * cin
                    out.append(LayerTrace(f"{nm}.{branch}.pool", "pool",
                                          el * 9, 0.0, 2 * el * BYTES))
                for j, (cout, k, s) in enumerate(chain):
                    c = conv(f"{nm}.{branch}.c{j}", c, cout, k, s, bn=with_bn)
            C = op["b1"] + op["b3"] + op["b5"] + op["bp"]
            H, W = Hs, Ws
            el = H * W * C
            out.append(LayerTrace(f"{nm}.concat", "concat", 0.0, 0.0,
                                  2 * el * BYTES))
        elif kind == "resblock":
            cin = C
            s = op["s"]
            conv(f"{nm}.c1", cin, op["c1"], 1, s)
            conv(f"{nm}.c3", op["c1"], op["c3"], 3, 1)
            conv(f"{nm}.cout", op["c3"], op["cout"], 1, 1, relu=False)
            if op["proj"]:
                # projection shortcut runs at the block's input resolution
                t, _, _ = _conv_trace(f"{nm}.proj", H * s, W * s, cin,
                                      op["cout"], 1, s)
                out.append(t)
                if with_bn:
                    aux(f"{nm}.proj.bn", "bn", H, W, op["cout"], 2.0)
            el = H * W * op["cout"]
            out.append(LayerTrace(f"{nm}.add", "relu", 2.0 * el, 0.0,
                                  3 * el * BYTES))
            C = op["cout"]
        else:
            raise ValueError(kind)
    return out


def model_traces(name: str, img: int | None = None) -> List[LayerTrace]:
    return trace_ops(CNN_OPS[name](), img or CNN_INPUT[name],
                     with_bn=(name != "vgg16"))


# ---------------------------------------------------------------------------
# runnable forward (interprets the same op lists)
# ---------------------------------------------------------------------------


def _normal(generator, shape, scale, dtype, device):
    """f32 normal draws on the CPU from ``generator``, scaled, cast to
    ``dtype`` and moved to ``device``: one seed gives the card and the CPU
    the same weights."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32)
            * scale).to(dtype).to(device)


def _conv_init(generator, k, cin, cout, dtype, device):
    return _normal(generator, (k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)),
                   dtype, device)


def init_cnn(generator: torch.Generator, name: str, img: int | None = None,
             dtype=torch.float32, device=DEFAULT_DEVICE) -> list:
    """One dict of tensors per op of ``CNN_OPS[name]`` (empty for pooling,
    gap and flatten), with the reference's keys, shapes and He scales:
    conv ``w`` (k, k, cin, cout) x sqrt(2 / fan_in), ``scale`` ones,
    ``shift`` zeros; fc ``w`` (cin, cout) x sqrt(1 / cin), ``b`` zeros.
    ``generator`` is a CPU ``torch.Generator``: the draws are made on the
    CPU and then moved to ``device``.  ``img`` sizes VGG's first fc."""
    dev = resolve(device)
    ops = CNN_OPS[name]()
    img = img or CNN_INPUT[name]
    params = []
    H = W = img
    C = 3
    for op in ops:
        kind = op["kind"]
        if kind == "conv":
            params.append({
                "w": _conv_init(generator, op["k"], C, op["cout"], dtype, dev),
                "scale": torch.ones((op["cout"],), dtype=dtype, device=dev),
                "shift": torch.zeros((op["cout"],), dtype=dtype, device=dev)})
            C = op["cout"]
            H, W = -(-H // op["s"]), -(-W // op["s"])
        elif kind == "maxpool":
            params.append({})
            H, W = -(-H // op["s"]), -(-W // op["s"])
        elif kind == "gap":
            params.append({})
            H = W = 1
        elif kind == "flatten":
            params.append({})
            C = H * W * C
            H = W = 1
        elif kind == "fc":
            cin = H * W * C if H > 1 else C
            params.append({
                "w": _normal(generator, (cin, op["cout"]),
                             math.sqrt(1.0 / cin), dtype, dev),
                "b": torch.zeros((op["cout"],), dtype=dtype, device=dev)})
            H = W = 1
            C = op["cout"]
        elif kind == "inception":
            params.append({
                "b1": _conv_init(generator, 1, C, op["b1"], dtype, dev),
                "b3r": _conv_init(generator, 1, C, op["b3r"], dtype, dev),
                "b3": _conv_init(generator, 3, op["b3r"], op["b3"], dtype,
                                 dev),
                "b5r": _conv_init(generator, 1, C, op["b5r"], dtype, dev),
                "b5": _conv_init(generator, 5, op["b5r"], op["b5"], dtype,
                                 dev),
                "bp": _conv_init(generator, 1, C, op["bp"], dtype, dev)})
            C = op["b1"] + op["b3"] + op["b5"] + op["bp"]
        elif kind == "resblock":
            p = {"c1": _conv_init(generator, 1, C, op["c1"], dtype, dev),
                 "c3": _conv_init(generator, 3, op["c1"], op["c3"], dtype,
                                  dev),
                 "cout": _conv_init(generator, 1, op["c3"], op["cout"],
                                    dtype, dev)}
            if op["proj"]:
                p["proj"] = _conv_init(generator, 1, C, op["cout"], dtype, dev)
            params.append(p)
            C = op["cout"]
            H, W = -(-H // op["s"]), -(-W // op["s"])
        else:
            raise ValueError(kind)
    return params


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """x: (N, H, W, C) -> SAME max pool (k x k, stride s), the border
    filled with -inf as the reference's ``lax.reduce_window(-inf, max,
    ..., "SAME")`` pads it.  NHWC in and out."""
    xp = pad_same(x, k, k, s, value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


def apply_cnn(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC -> logits (B, 1000); runs on x's device."""
    ops = CNN_OPS[name]()
    relu = torch.relu
    for op, p in zip(ops, params):
        kind = op["kind"]
        if kind == "conv":
            x = conv2d(x, p["w"], stride=op["s"])
            x = relu(x * p["scale"] + p["shift"])
        elif kind == "maxpool":
            x = max_pool_same(x, op["k"], op["s"])
        elif kind == "gap":
            x = x.mean(dim=(1, 2), keepdim=True)
        elif kind == "flatten":
            x = x.reshape(x.shape[0], 1, 1, -1)
        elif kind == "fc":
            x = matmul(x.reshape(x.shape[0], -1), p["w"]) + p["b"]
            if op["relu"]:
                x = relu(x)
            x = x.reshape(x.shape[0], 1, 1, -1)
        elif kind == "inception":
            b1 = relu(conv2d(x, p["b1"]))
            b3 = relu(conv2d(relu(conv2d(x, p["b3r"])), p["b3"]))
            b5 = relu(conv2d(relu(conv2d(x, p["b5r"])), p["b5"]))
            bp = relu(conv2d(max_pool_same(x, 3, 1), p["bp"]))
            x = torch.cat([b1, b3, b5, bp], dim=-1)
        elif kind == "resblock":
            h = relu(conv2d(x, p["c1"], stride=op["s"]))
            h = relu(conv2d(h, p["c3"]))
            h = conv2d(h, p["cout"])
            sc = conv2d(x, p["proj"], stride=op["s"]) if "proj" in p else x
            x = relu(h + sc)
        else:
            raise ValueError(kind)
    return x.reshape(x.shape[0], -1)
