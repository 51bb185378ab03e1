"""Builds the port's CUDA kernels (csrc/) with nvcc and loads them with ctypes.

Route: nvcc into shared libraries with a plain C interface (no PyTorch
headers, so a build takes seconds), at first use, into ``.torch_build/`` at
the repository root (git-ignored).  Each translation unit of ``UNITS`` is
its own library, and their nvcc processes run at once, so the build takes
as long as the slowest unit.  A library's name carries a digest of its
sources and flags, so an edited source rebuilds and a stale library is
never loaded.  ``ptxas`` resource usage (registers, spills) is kept beside
each library in ``<lib>.resource.txt``; ``resource_lines`` reads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
import types

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_build"
HEADERS = ("field.cuh", "mul_modes.cuh", "mul_ptx.cuh", "curve.cuh", "curve_kernels.cuh", "curve_unit.cuh",
           "fold_mma.cuh", "add_team.cuh", "add_team_g2.cuh")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--resource-usage",
)
_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
# translation unit -> {extern "C" launcher: argtypes}; every launcher returns int
UNITS = {
    "kernels.cu": {
        "vs_mont_mul": [ctypes.c_int, _VP, _VP, _VP, _LL, _LL, _VP],
        "vs_madd": [ctypes.c_int] + [_VP] * 11 + [_LL, _VP],
        "vs_g1_add": [_VP] * 9 + [_LL, _VP],
        "vs_mont_inv": [ctypes.c_int, _VP, _VP, _LL, _VP],
        "vs_double": [ctypes.c_int] + [_VP] * 6 + [_LL, ctypes.c_int, _VP],
        "vs_madd_scan": [ctypes.c_int, _VP, _VP, _VP, ctypes.c_int, _LL] + [_VP] * 5,
        "vs_add_shift": [ctypes.c_int] + [_VP] * 6 + [_LL, ctypes.c_int, ctypes.c_int, _VP],
    },
    "add_team.cu": {
        "vs_g2_add_team": [_VP] * 9 + [_LL, _VP],
    },
    "add_distinct.cu": {
        "vs_add_distinct": [ctypes.c_int] + [_VP] * 9 + [_LL, _VP],
        "vs_window_sum": [ctypes.c_int] + [_VP] * 7 + [_LL, ctypes.c_int, _VP],
        "vs_addx": [ctypes.c_int] + [_VP] * 10 + [_LL, _VP],
    },
    "mont_mul_modes.cu": {
        "vs_mont_mul_mode": [ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _LL, _VP],
        "vs_mont_mul_fold_upload": [ctypes.c_int, _VP, _LL],
    },
    "micro.cu": {
        "vs_mul_chain": [ctypes.c_int, _VP, _VP, _VP, _VP, _LL, _VP],
        "vs_op": [ctypes.c_int, _VP, _VP, _VP, _LL, _VP],
        "vs_mul_chain_info": [ctypes.c_int, _VP],
        "vs_micro_fold_mma_upload": [ctypes.c_int, _VP, _LL],
    },
}
# the curve kernels and K1's Fermat chain in v1 and fold (curve_v1.cu,
# curve_fold.cu): every loop launcher of these units but K1's, with the
# mode's suffix, the fold unit's own fold-matrix uploads (the dp4a fold's
# __constant__ matrices; the tensor-core fold's B operand, which also lets
# its instances take their shared memory) and what the runtime reports of
# those instances
CURVE_LAUNCHERS = {name: args for unit in ("kernels.cu", "add_team.cu", "add_distinct.cu")
                   for name, args in UNITS[unit].items() if name != "vs_mont_mul"}
UNITS["curve_v1.cu"] = {f"{name}_v1": args for name, args in CURVE_LAUNCHERS.items()}
UNITS["curve_fold.cu"] = {**{f"{name}_fold": args for name, args in CURVE_LAUNCHERS.items()},
                          "vs_curve_fold_upload": [ctypes.c_int, _VP, _LL],
                          "vs_curve_fold_mma_upload": [ctypes.c_int, _VP, _LL],
                          "vs_curve_fold_mma_info": [ctypes.c_int, _VP]}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _digest(unit: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (*HEADERS, unit):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(unit: str) -> pathlib.Path:
    return BUILD_DIR / f"libvstorch_{pathlib.Path(unit).stem}_{_digest(unit)}.so"


class KernelLib:
    """The loaded kernel libraries plus what their build reported; ``lib``
    holds every launcher of every unit as an attribute."""

    def __init__(self, paths: list[pathlib.Path], build_seconds: float):
        self.paths = paths
        self.build_seconds = build_seconds
        self.resource_usage = ""
        fns = {}
        for unit, path in zip(UNITS, paths):
            res = path.with_suffix(".resource.txt")
            if res.exists():
                self.resource_usage += res.read_text()
            lib = ctypes.CDLL(str(path))
            for name, args in UNITS[unit].items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                fns[name] = fn
        self.lib = types.SimpleNamespace(**fns)


def build() -> tuple[list[pathlib.Path], float]:
    """Compile every unit whose library for these sources is missing, all
    nvcc processes at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(u) for u in UNITS]
    t0 = time.time()
    procs = []
    for unit, out in zip(UNITS, outs):
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / unit)]
        procs.append((out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n{stdout}\n{stderr}")
            continue
        out.with_suffix(".resource.txt").write_text(stdout + stderr)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs, (time.time() - t0) if procs else 0.0


def compile_seconds(unit: str, defines: tuple[str, ...] = ()) -> tuple[float, str]:
    """Build `unit` once more with extra -D defines into a scratch library
    and delete it: (nvcc wall seconds, its resource-usage report).  The K8
    probe times one multiplier variant's build this way."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"variant_{pathlib.Path(unit).stem}_{os.getpid()}.so"
    cmd = [nvcc(), *FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(CSRC / unit)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.time() - t0
    tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {unit} {defines}:\n{proc.stdout}\n{proc.stderr}")
    return secs, proc.stdout + proc.stderr


def sass(unit: str) -> str:
    """``cuobjdump -sass`` of `unit`'s built library (build it first)."""
    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(unit))], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def short_name(mangled: str) -> str:
    """k_add<Fq2,MulLoop>-style name of a mangled kernel or device function
    (template arguments: the field, the multiplier mode, Called<mode> for
    its out-of-line form, integer constants; MulFoldMmaOf<P> is
    MulFoldMmaOf, its field the kernel's)."""
    m = re.search(r"(k_[a-z_]+|mul_fold|mul_called|fq_mul_call)(I.*)?$", mangled)
    if not m:
        return mangled
    args = re.findall(r"FqParams|FrParams|AddTeamG2|Fq2|CalledI\d*Mul(?:Loop|V1|FoldMma|Fold)|MulLoopPtx|MulV1Ptx|"
                      r"MulLoop|MulV1|"
                      r"MulFoldMmaOf|MulFoldMma|MulFold|Li\d+E", m.group(2) or "")
    args = [a[2:-1] if a.startswith("Li") else f"Called<{a[a.index('Mul'):]}>" if a.startswith("Called") else a
            for a in args]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def resource_lines(report: str) -> list[tuple[str, int, int]]:
    """ptxas's report -> (short_name, registers, spill-store bytes) per
    kernel or out-of-line device function."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        if "Function properties for" in line:
            name = short_name(line.split("for", 1)[1].strip())
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1].strip())
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(line.split("Used", 1)[1].split("registers")[0].strip()), spill))
            name, spill = None, 0
    return out


@functools.cache
def load() -> KernelLib:
    paths, secs = build()
    return KernelLib(paths, secs)
