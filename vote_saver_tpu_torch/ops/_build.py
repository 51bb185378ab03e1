"""Builds the port's CUDA kernels (csrc/) with nvcc and loads them with ctypes.

Route: nvcc into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), at first use, into ``.torch_build/`` at
the repository root (git-ignored).  The library name carries a digest of the
sources and flags, so an edited source rebuilds and a stale library is never
loaded.  ``ptxas`` resource usage (registers, spills) is kept beside the
library in ``<lib>.resource.txt``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_build"
SOURCES = ("field.cuh", "curve.cuh", "kernels.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--resource-usage",
)


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class KernelLib:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, path: pathlib.Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        res = path.with_suffix(".resource.txt")
        self.resource_usage = res.read_text() if res.exists() else ""
        lib = ctypes.CDLL(str(path))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        sig = {
            "vs_mont_mul": [ctypes.c_int, vp, vp, vp, ll, vp],
            "vs_madd": [ctypes.c_int] + [vp] * 11 + [ll, vp],
            "vs_add": [ctypes.c_int] + [vp] * 9 + [ll, vp],
            "vs_double": [ctypes.c_int] + [vp] * 6 + [ll, vp],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        self.lib = lib


def build() -> tuple[pathlib.Path, float]:
    """Compile csrc/kernels.cu unless the library for these sources exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libvstorch_{_digest()}.so"
    if out.exists():
        return out, 0.0
    t0 = time.time()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / "kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".resource.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, time.time() - t0


@functools.cache
def load() -> KernelLib:
    path, secs = build()
    return KernelLib(path, secs)
