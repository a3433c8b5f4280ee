"""The PyTorch port stands alone, and its kernel wrappers never fall back.

* No module of ``src/repro_torch/``, not ``chip_smoke.py`` and no
  ``tools/torch_*.py`` or ``examples/torch_*.py`` imports ``jax``,
  ``ml_dtypes`` (which ships with jax; the card's machine has neither)
  or anything of the JAX
  package ``repro`` (the port keeps its own copies of the host modules it
  needs).
* Each kernel wrapper (``ops.py``) sends a CPU tensor to its plain
  PyTorch version and counts no launch; a tensor on any other non-CUDA
  device raises instead of being served by the plain version.
* Asking for CUDA without a card raises; nothing drops to the CPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as D
from repro_torch.kernels.conv2d import ops as cv_ops
from repro_torch.kernels.conv2d import ref as cv_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul import ref as mm_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_has_files():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "engine.py", "ops.py", "serve.py",
            "torch_trace_export.py", "cluster.py", "protocol.py",
            "torch_make_reference_profile.py", "torch_quickstart.py",
            "torch_partitioned_training.py",
            "torch_traffic_shaping_demo.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path}: imports {bad}"


def _mm_args():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((5, 7), np.float32)),
            torch.from_numpy(rng.standard_normal((7, 3), np.float32)))


def _fa_args():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 6, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 8), np.float32))
    return q, k, k * 0.5


def _pa_args():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8), np.float32))
    kp = torch.from_numpy(rng.standard_normal((5, 4, 2, 8), np.float32))
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    cur = torch.tensor([6, 2], dtype=torch.int32)
    return q, kp, kp * 0.5, tables, cur


def _pq_args():
    q, kp, vp, tables, cur = _pa_args()
    kq = (kp * 20).round().clamp(-127, 127).to(torch.int8)
    scales = torch.full((kp.shape[0], kp.shape[2]), 0.05)
    return q, kq, kq.flip(1), scales, scales * 2, tables, cur


def _fd_args():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 2, 8), np.float32))
    return q, k, k * 0.5, torch.tensor([8, 3], dtype=torch.int32)


def _cv_args():
    rng = np.random.default_rng(4)
    return (torch.from_numpy(rng.standard_normal((2, 6, 6, 4), np.float32)),
            torch.from_numpy(rng.standard_normal((3, 3, 4, 5), np.float32)))


def _cv_plain(x, w):   # the wrapper pads SAME, the plain version does not
    return cv_ref.conv2d(cv_ops.pad_same(x, 3, 3, 1), w)


WRAPPERS = {
    "conv2d": (cv_ops.conv2d, _cv_plain, _cv_args),
    "matmul": (mm_ops.matmul, mm_ref.matmul, _mm_args),
    "flash_attention": (fa_ops.flash_attention, fa_ref.attention, _fa_args),
    "paged_decode": (pa_ops.paged_decode, pa_ref.paged_decode_attention,
                     _pa_args),
    "paged_decode_sparse": (pa_ops.paged_decode_sparse,
                            pa_ref.paged_decode_attention_sparse, _pa_args),
    "paged_decode_quant": (pa_ops.paged_decode_quant,
                           pa_ref.paged_decode_attention_quant, _pq_args),
    "flash_decode": (fd_ops.flash_decode, fd_ref.decode_attention, _fd_args),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensor_routes_to_plain_version(name):
    op, plain, make = WRAPPERS[name]
    before = op.launches
    out = op(*make())
    assert op.launches == before          # no kernel was launched
    torch.testing.assert_close(out, plain(*make()), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_other_devices_raise_not_fall_back(name):
    op, _, make = WRAPPERS[name]
    args = [a.to("meta") for a in make()]
    with pytest.raises(ValueError, match="no kernel"):
        op(*args)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        D.resolve("cuda")
    assert D.resolve("cpu") == torch.device("cpu")
    assert D.DEFAULT_DEVICE == "cuda"
