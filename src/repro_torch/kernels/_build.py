"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``kernels/csrc/`` with a plain C
interface.  ``build`` compiles the sources with ``nvcc`` for ``sm_90a``
(Hopper) into shared libraries under ``build/kernels/`` at the repository
root, one ``nvcc`` process per source, all started together; ``load``
opens one library with ``ctypes`` and declares its entry points.  A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.  Every C entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises when it is not
``cudaSuccess`` (a launch the runtime refuses never runs, and a later
``torch.cuda.synchronize()`` would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("matmul", "matmul_wgmma", "flash_attention",
           "flash_attention_bwd", "paged_attention", "flash_decode", "conv2d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}   # loaded libraries, by source name


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels build only where the CUDA toolkit is "
                           "installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes in parallel.  Returns ``{name: {"seconds", "ptxas"}}`` for the
    sources compiled now (``ptxas`` is the register/shared-memory report of
    ``-Xptxas=-v``); raises with the compiler's output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": stdout + stderr}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Open (building first if needed) the library of ``csrc/<name>.cu``
    and declare ``signatures`` ({function: argtypes}); every entry point
    returns an ``int`` CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# packed page dtype codes shared with csrc/paged_attention.cu
PAGE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}")
    return code


def page_code(t: torch.Tensor) -> int:
    code = PAGE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"packed KV pages are int8 or float8_e4m3fn, got "
                        f"{t.dtype}")
    return code


def check_inputs(what: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
