"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``.  Builds happen on first use,
never at import, into ``innfer_tpu_torch/build/`` (listed in .gitignore),
named by a hash of the source, the ``csrc/*.cuh`` headers it includes and
the flags, so an edit of either rebuilds.
Each library has its own lock, so two libraries build at once from two
threads.  The loaded-library cache is the package's only global state.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float   # compile time in this process (0.0 when already built)
    ptxas: str       # nvcc's -Xptxas -v report ("" when already built)


_built: Dict[str, Built] = {}
_locks: Dict[str, threading.Lock] = defaultdict(threading.Lock)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin); the port's "
        "CUDA kernels are built from source on the machine with the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_includes(path: str) -> List[str]:
    """The ``csrc/`` files that ``path`` includes with ``#include "..."``,
    directly or through another such file, in first-seen order."""
    seen: List[str] = []
    todo = [path]
    while todo:
        with open(todo.pop(0), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(CSRC, inc.decode())
            if os.path.isfile(dep) and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every local header it includes, and the
    flags: the build's name, so that an edit of any of them rebuilds."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *local_includes(src)]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (once per process and source) and load it."""
    with _locks[name]:
        if name in _built:
            return _built[name]
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
        seconds, report = 0.0, ""
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)  # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            seconds = time.perf_counter() - t0
            report = proc.stdout + proc.stderr
        built = Built(ctypes.CDLL(out), out, seconds, report)
        _built[name] = built
        return built


_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# each library's C entry points: (argument types, return type)
SIGNATURES = {
    "rdb": {
        "innfer_rdb_forward": ([_vp] * 6 + [_i] * 7 + [_vp], _i),
        "innfer_rdb_forward_ws": ([_vp] * 6 + [_i] * 7 + [_f, _vp], _i),
    },
    "resnet_block": {
        "innfer_resnet_block_forward": ([_vp] * 8 + [_i] * 4 + [_f, _i, _vp], _i),
        "innfer_resnet_block_stats_floats": ([_i] * 5, _ll),
    },
}


def library(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C signatures declared."""
    lib = build(name).lib
    with _locks[name]:
        if not getattr(lib, "_innfer_declared", False):
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.innfer_conv_tc_smem_bytes.argtypes = [_i]
            lib.innfer_conv_tc_smem_bytes.restype = _i
            lib.innfer_cuda_error_string.argtypes = [_i]
            lib.innfer_cuda_error_string.restype = ctypes.c_char_p
            lib._innfer_declared = True
    return lib


def rdb_library() -> ctypes.CDLL:
    """The fused-RDB library (``csrc/rdb.cu``)."""
    return library("rdb")


def resnet_block_library() -> ctypes.CDLL:
    """The fused-ResnetBlock library (``csrc/resnet_block.cu``)."""
    return library("resnet_block")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: CUDA error {err} "
                           f"({lib.innfer_cuda_error_string(err).decode()})")
