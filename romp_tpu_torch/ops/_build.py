"""Build the port's CUDA kernels at first use and load them with ctypes.

`romp_tpu_torch/csrc/*.cu` are compiled by `nvcc` for `sm_90a`, one
process per source, all started together, and linked into ONE shared
library with a plain C interface, written to `build/romp_tpu_torch/` at the
repository root (git-ignored). The library's name carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time: the CPU tests import every module
on a machine without `nvcc`.

Not `torch.utils.cpp_extension.load`: a source that includes PyTorch's
headers takes minutes to compile, a plain-C one seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "romp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
# compile step only: ptxas reports each kernel's registers, spills and
# static shared memory, kept beside the library (`kernel_resources`)
PTXAS_FLAGS = ["-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as void*).
SIGNATURES = {
    "romp_skinning_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "romp_skinning_bwd_f32": [_P] * 7 + [_I] * 5 + [_P],
    "romp_skinning_bwd_occupancy": [_P],
    "romp_conv3x3_bn_act": [_P] * 8 + [_I] * 8 + [_P],
    "romp_basic_chain": [_P] * 9 + [_I] * 9 + [_P],
    "romp_basic_chain_bf16": [_P] * 10 + [_I] * 9 + [_P],
    "romp_chain_bf16_fused": [_P] * 7 + [_I] * 12 + [_P],
    "romp_chain_bf16_fused_plan": [_I] * 8 + [_P],
    "romp_deform_conv2d_f32": [_P] * 5 + [_I] * 7 + [_P],
    "romp_deform_conv2d_bf16": [_P] * 4 + [_I] * 8 + [_P],
    "romp_deform_conv2d_bf16_plan": [_I] * 7 + [_P],
    "romp_deform_conv2d_bwd_plan": [_I] * 7 + [_P],
    "romp_deform_conv2d_bwd_f32": [_P] * 8 + [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    return BUILD_DIR / f"libromp_kernels_{h.hexdigest()[:16]}.so"


def _ptxas_log() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c",
                                   "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(_sources(), objs)]
        errors, logs = [], []
        for src, proc in zip(_sources(), procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                errors.append(f"nvcc {src.name} failed ({proc.returncode}):"
                              f"\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        _ptxas_log().write_text("".join(logs))
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_resources(name: str) -> List[dict]:
    """What ptxas reported for each kernel whose mangled name contains
    `name`: registers, spill stores / loads and stack frame in bytes,
    static shared memory in bytes (dynamic shared memory is not in it)."""
    build()
    rows, cur = [], None
    for line in _ptxas_log().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(kernel=m.group(1)) if name in m.group(1) else None
            if cur is not None:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


@functools.lru_cache(maxsize=None)
def _sass(library: str) -> str:
    """`cuobjdump -sass` of the library (which ships with nvcc), read once
    for all the kernels asked about."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(home, "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found (set CUDA_HOME)")
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout


def sass_opcodes(name: str, opcodes: Tuple[str, ...]) -> dict:
    """For each kernel of the built library whose mangled name contains
    `name`: the count of SASS instructions that start with one of
    `opcodes`, from `cuobjdump -sass`. Raises if cuobjdump is missing or
    finds no such kernel."""
    counts, cur = {}, None
    for line in _sass(str(build())).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur is not None:
                counts[cur] = 0
            continue
        if cur is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and m.group(1).startswith(opcodes):
                counts[cur] += 1
    if not counts:
        raise RuntimeError(f"no kernel named *{name}* in {build().name}")
    return counts


def check_operand(what: str, name: str, t, dtype, shape, device) -> None:
    """Raise ValueError unless tensor t is on `device`, of `dtype` and
    `shape`, and contiguous: what a kernel's raw pointer needs."""
    if t.device != device:
        raise ValueError(f"{what}: {name} on {t.device}, needs {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} is {t.dtype} {tuple(t.shape)}, "
                         f"needs {dtype} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def check_no_grad(what: str, *tensors) -> None:
    """Raise under grad mode if an operand requires grad: the CUDA kernels
    are forward only, and their outputs (filled through a raw pointer)
    would carry no graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; run it under "
            "torch.no_grad() or inference_mode, or on operands that do not "
            "require grad")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
