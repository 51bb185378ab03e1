"""ctypes bridge to the native C++ curve kernels (native/vs_native.cpp).

Builds the shared library on first use (g++ -O3, cached in .torch_build/)
and exposes MSM / fixed-base / pointwise scalar multiplication with the same
host-int interface as refimpl.jacobian — which transparently dispatches here
when the library is available (disable with VSTPU_NATIVE=0).

ABI: affine points as 6x64-bit little-endian standard-form limbs per Fq
coordinate (G1: x‖y = 12 u64; G2: x0‖x1‖y0‖y1 = 24 u64), infinity as a
separate u8 flag array, scalars as 32-byte little-endian integers.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .params import R

# The port's copy of vote_saver_tpu/native_bridge.py.  It compiles the same
# C++ source (native/vs_native.cpp at the repository root) into the port's
# own build directory, under a name that carries a digest of the source and
# flags, and never writes the JAX package's native/libvs_native.so.
_SRC = pathlib.Path(__file__).resolve().parents[1] / "native" / "vs_native.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / ".torch_build"
_CMD = ("g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(_CMD).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libvs_native_{digest}.so"


def _build() -> pathlib.Path:
    lib = _lib_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one compiler per library: concurrent processes wait for the first
    with open(_BUILD_DIR / "libvs_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            subprocess.run([*_CMD, str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, lib)
    return lib


@functools.cache
def get_lib():
    """The loaded library, or None when disabled/unbuildable."""
    if os.environ.get("VSTPU_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
    except Exception:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, args in [
        ("vs_g1_msm", [u64p, u8p, u8p, ctypes.c_size_t, ctypes.c_int, u64p, u8p]),
        ("vs_g2_msm", [u64p, u8p, u8p, ctypes.c_size_t, ctypes.c_int, u64p, u8p]),
        ("vs_g1_fixed_base", [u64p, u8p, ctypes.c_size_t, ctypes.c_int, u64p, u8p]),
        ("vs_g2_fixed_base", [u64p, u8p, ctypes.c_size_t, ctypes.c_int, u64p, u8p]),
        ("vs_g1_mul_many", [u64p, u8p, u8p, ctypes.c_size_t, u64p, u8p]),
        ("vs_g2_mul_many", [u64p, u8p, u8p, ctypes.c_size_t, u64p, u8p]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    lib.vs_pairing_check.argtypes = [u64p, u8p, u64p, u8p, ctypes.c_size_t]
    lib.vs_pairing_check.restype = ctypes.c_int
    for name in ("vs_g1_decompress_many", "vs_g2_decompress_many"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_size_t, u64p, u8p]
        fn.restype = ctypes.c_longlong
    i16p = ctypes.POINTER(ctypes.c_int16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vs_sched_pass1.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, u8p, i16p, u32p,
        ctypes.c_int,
    ]
    lib.vs_sched_pass1.restype = ctypes.c_longlong
    lib.vs_sched_pass2.argtypes = [
        i16p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, u8p, u32p, i32p,
        ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
    ]
    lib.vs_sched_pass2.restype = None
    assert lib.vs_abi_version() == 1
    return lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _fq_to_limbs(x: int) -> list[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6)]


def _limbs_to_int(a) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(a))


def _pack_g1(points) -> tuple[np.ndarray, np.ndarray]:
    n = len(points)
    coords = np.zeros((n, 12), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            coords[i, :6] = _fq_to_limbs(p[0])
            coords[i, 6:] = _fq_to_limbs(p[1])
    return coords, inf


def _unpack_g1(coords, inf, i: int):
    if inf[i]:
        return None
    return (_limbs_to_int(coords[i, :6]), _limbs_to_int(coords[i, 6:]))


def _pack_g2(points) -> tuple[np.ndarray, np.ndarray]:
    n = len(points)
    coords = np.zeros((n, 24), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            (x0, x1), (y0, y1) = p
            coords[i, 0:6] = _fq_to_limbs(x0)
            coords[i, 6:12] = _fq_to_limbs(x1)
            coords[i, 12:18] = _fq_to_limbs(y0)
            coords[i, 18:24] = _fq_to_limbs(y1)
    return coords, inf


def _unpack_g2(coords, inf, i: int):
    if inf[i]:
        return None
    c = coords[i]
    return (
        (_limbs_to_int(c[0:6]), _limbs_to_int(c[6:12])),
        (_limbs_to_int(c[12:18]), _limbs_to_int(c[18:24])),
    )


def _pack_scalars(scalars) -> np.ndarray:
    n = len(scalars)
    out = np.zeros((n, 32), dtype=np.uint8)
    for i, s in enumerate(scalars):
        out[i] = np.frombuffer((int(s) % R).to_bytes(32, "little"), dtype=np.uint8)
    return out


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


def msm(points, scalars, group: str = "g1", window_bits: int = 8):
    lib = get_lib()
    pack, unpack, fn, width = (
        (_pack_g1, _unpack_g1, lib.vs_g1_msm, 12)
        if group == "g1"
        else (_pack_g2, _unpack_g2, lib.vs_g2_msm, 24)
    )
    coords, inf = pack(points)
    sc = _pack_scalars(scalars)
    out = np.zeros((1, width), dtype=np.uint64)
    out_inf = np.zeros(1, dtype=np.uint8)
    fn(_u64p(coords), _u8p(inf), _u8p(sc), len(points), window_bits, _u64p(out), _u8p(out_inf))
    return unpack(out, out_inf, 0)


def fixed_base(base, scalars, group: str = "g1", window_bits: int = 8) -> list:
    lib = get_lib()
    pack, unpack, fn, width = (
        (_pack_g1, _unpack_g1, lib.vs_g1_fixed_base, 12)
        if group == "g1"
        else (_pack_g2, _unpack_g2, lib.vs_g2_fixed_base, 24)
    )
    coords, _ = pack([base])
    sc = _pack_scalars(scalars)
    n = len(scalars)
    out = np.zeros((n, width), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    fn(_u64p(coords), _u8p(sc), n, window_bits, _u64p(out), _u8p(out_inf))
    return [unpack(out, out_inf, i) for i in range(n)]


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over (G1, G2) affine int pairs."""
    lib = get_lib()
    n = len(pairs)
    g1 = np.zeros((n, 12), np.uint64)
    g1i = np.zeros(n, np.uint8)
    g2 = np.zeros((n, 24), np.uint64)
    g2i = np.zeros(n, np.uint8)
    for i, (p, q) in enumerate(pairs):
        if p is None:
            g1i[i] = 1
        else:
            g1[i, :6] = _fq_to_limbs(p[0])
            g1[i, 6:] = _fq_to_limbs(p[1])
        if q is None:
            g2i[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            g2[i, 0:6] = _fq_to_limbs(x0)
            g2[i, 6:12] = _fq_to_limbs(x1)
            g2[i, 12:18] = _fq_to_limbs(y0)
            g2[i, 18:24] = _fq_to_limbs(y1)
    return bool(lib.vs_pairing_check(_u64p(g1), _u8p(g1i), _u64p(g2), _u8p(g2i), n))


def g1_mul_many(points, scalars) -> list:
    lib = get_lib()
    coords, inf = _pack_g1(points)
    sc = _pack_scalars(scalars)
    n = len(points)
    out = np.zeros((n, 12), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    lib.vs_g1_mul_many(_u64p(coords), _u8p(inf), _u8p(sc), n, _u64p(out), _u8p(out_inf))
    return [_unpack_g1(out, out_inf, i) for i in range(n)]


def g2_mul_many(points, scalars) -> list:
    lib = get_lib()
    coords, inf = _pack_g2(points)
    sc = _pack_scalars(scalars)
    n = len(points)
    out = np.zeros((n, 24), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    lib.vs_g2_mul_many(_u64p(coords), _u8p(inf), _u8p(sc), n, _u64p(out), _u8p(out_inf))
    return [_unpack_g2(out, out_inf, i) for i in range(n)]


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def sched_threads() -> int:
    return min(16, os.cpu_count() or 1)


def sched_pass1(scalar_bytes: np.ndarray, parts: int, n: int, w: int, inf_mask):
    """scalar_bytes: (parts*n, 32) uint8 C-contiguous LE scalars.
    Returns (total, digits (parts*n, K) int16, counts (T, canon) uint32)."""
    lib = get_lib()
    nbits = 256 + w
    K = nbits // w + (1 if nbits % w else 0)
    canon = parts * K << (w - 1)
    T = sched_threads()
    digits = np.empty((parts * n, K), dtype=np.int16)
    counts = np.zeros((T, canon), dtype=np.uint32)
    inf = None
    infp = ctypes.POINTER(ctypes.c_uint8)()
    if inf_mask is not None:
        inf = np.ascontiguousarray(np.asarray(inf_mask, dtype=np.uint8))
        infp = _u8p(inf)
    total = lib.vs_sched_pass1(
        _u8p(scalar_bytes), parts, n, w, infp, _i16p(digits), _u32p(counts), T
    )
    return int(total), digits, counts


def sched_pass2(digits, parts, n, w, inf_mask, counts, orph_base, steps_budget,
                nsteps, lanes):
    lib = get_lib()
    codes = np.zeros((nsteps, lanes), dtype=np.int32)
    inf = None
    infp = ctypes.POINTER(ctypes.c_uint8)()
    if inf_mask is not None:
        inf = np.ascontiguousarray(np.asarray(inf_mask, dtype=np.uint8))
        infp = _u8p(inf)
    lib.vs_sched_pass2(
        _i16p(digits), parts, n, w, infp, _u32p(counts), _i32p(orph_base),
        steps_budget, lanes, _i32p(codes), counts.shape[0],
    )
    return codes


def g1_decompress_many(blob: bytes, n: int) -> list:
    """n compressed 48B G1 points -> affine int points (None = infinity)."""
    lib = get_lib()
    data = np.frombuffer(blob, dtype=np.uint8, count=n * 48)
    out = np.zeros((n, 12), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    rc = lib.vs_g1_decompress_many(_u8p(data), n, _u64p(out), _u8p(out_inf))
    if rc:
        raise ValueError(f"bad compressed G1 point at index {rc - 1}")
    return [_unpack_g1(out, out_inf, i) for i in range(n)]


def g2_decompress_many(blob: bytes, n: int) -> list:
    lib = get_lib()
    data = np.frombuffer(blob, dtype=np.uint8, count=n * 96)
    out = np.zeros((n, 24), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    rc = lib.vs_g2_decompress_many(_u8p(data), n, _u64p(out), _u8p(out_inf))
    if rc:
        raise ValueError(f"bad compressed G2 point at index {rc - 1}")
    return [_unpack_g2(out, out_inf, i) for i in range(n)]
