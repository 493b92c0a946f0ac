"""Build and load the CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into
``<checkout>/build/cuda_kernels/lib<name>-<hash>.so`` (the directory is
git-ignored), with a plain C interface: pointers come from
``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``, and every entry point returns
its ``cudaGetLastError()`` code, which ``check`` turns into an exception.
The file name carries a hash of the sources and flags, so an edited source
rebuilds and concurrent processes never load a half-written library
(builds land under a temporary name and are renamed into place).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "cuda_kernels"

#: library name → (source file, C entry points with their argument kinds)
#: argument kinds: "p" pointer/stream (c_void_p), "i" int (c_int)
LIBRARIES = {
    "implicit_gemm": ("implicit_gemm.cu", {
        "igemm_dense": "pppppiiiiiip",
        "igemm_worklist": "pppppppiiiiiip",
    }),
    "fetch_on_demand": ("fetch_on_demand.cu", {
        "fod_forward": "pppppiiiiiip",
    }),
}
_ERROR_STRING = {"implicit_gemm": "igemm_error_string",
                 "fetch_on_demand": "fod_error_string"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / LIBRARIES[name][0]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named libraries (default: all) with one ``nvcc`` each, all
    started together.  Returns seconds per library (0.0 when up to date)."""
    names = list(names or LIBRARIES)
    t0 = time.perf_counter()
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / LIBRARIES[name][0])],
                stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp) in running.items():
        rc = proc.wait()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {name} (rc {rc}):\n"
                          f"{build_log(name)[-4000:]}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's output of the last build (ptxas register/smem report)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for fn, sig in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = [kinds[k] for k in sig]
        f.restype = ctypes.c_int
    err = getattr(lib, _ERROR_STRING[name])
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib


#: operand dtypes the kernels take, and their ``dtype`` code in the C ABI
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def current_stream() -> int:
    """Handle of PyTorch's current CUDA stream (kernels launch on it)."""
    return torch.cuda.current_stream().cuda_stream


def check(name: str, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
