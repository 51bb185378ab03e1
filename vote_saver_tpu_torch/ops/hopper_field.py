"""The port's Hopper kernels, their wrappers and plain versions.

Counterpart of ``vote_saver_tpu/ops/pallas_field.py``.  Each public function
keeps the signature and layout of its Pallas entry point:

  K1 ``mont_mul(name, a, b, mode=None)``           <- mont_mul_pallas
     ``mont_inv(name, a, mode=None)``: a^(N-2), the Fermat chain of K1 in
     one launch
  K2 ``g1_madd``/``g2_madd(acc, q_affine, sign, active) -> (acc', exc)``
                                                    <- g1/g2_madd_pallas
     ``g1_madd_scan``/``g2_madd_scan(points_xy, codes) -> (acc, exc)``: the
     bucket scan, every schedule row of an MSM in one launch
  K3 ``g1_add``/``g2_add(p, q)`` (complete)         <- g1/g2_add_pallas;
     ``g2_add`` runs a team of 16 threads a lane (``csrc/add_team.cu``,
     schedule ``ops/add_team.py``)
     ``g1_add_shift``/``g2_add_shift(coords, shift)``: one suffix round of
     the MSM's combination phase, its partner read in the kernel
  K3d ``g1_add_distinct``/``g2_add_distinct(p, q)`` <- g1/g2_add_pallas(complete=False)
     ``g1_window_sum``/``g2_window_sum(table, digits)``: FixedBaseTable.mul's
     window sum, the gather and the tree of 31 distinct adds an output in
     one launch
  K4 ``g1_double``/``g2_double(p, times=1)``        <- g1/g2_double_pallas,
     ``times`` doublings in one launch
  K5/K6 ``g1_addx``/``g2_addx(p, q) -> (coords, exc)`` <- g1/g2_addx_pallas

Every wrapper takes the multiplier mode ``mode``: ``loop`` (CIOS),
``v1`` (separated operand scanning) or ``fold`` (digit columns and a
constant-matrix fold, ``ops/fold_mul.py``); ``None``, the default, is
``mul_mode()``, which reads ``VSTPU_MUL`` at each call as the JAX package
does (unset: ``loop``).  All three give the same canonical limbs.  On a
CUDA tensor a wrapper launches that mode's instance (loop: ``kernels.cu``,
``add_team.cu``, ``add_distinct.cu``; v1 / fold: ``curve_v1.cu`` /
``curve_fold.cu``, K1 ``mont_mul_modes.cu``), counted under its name, the
loop name with ``_v1`` / ``_fold`` (``instance``), and raises where that
instance is missing or fails; it never runs another mode's instance.  In
fold the bucket scans, the suffix rounds, the doublings and the complete
adds of G1 and G2 and the Fq and Fr inversion chains (``MMA_KERNELS``:
every fold kernel of the vote path) run the fold product on the int8
tensor cores, a warp's lanes one tile.  On a CPU
tensor a wrapper runs the plain version, one function in every mode.

Coordinates are int32 tensors ``(..., L)`` (G1, Fq/Fr) or ``(..., 2, L)``
(G2) of 32-bit Montgomery limbs.  On a CUDA tensor a wrapper launches its
kernel from ``csrc/`` (``SOURCES`` names the file) or raises; on a CPU
tensor it runs the plain PyTorch version beside it.  The plain versions compute on int64
tensors of 16-bit half-limbs (CPU torch has no uint32/uint64 add, sub or
shift) with vectorised carry resolution, and follow the Pallas formulas'
select order exactly, so kernel and plain version agree limb for limb —
canonical infinity (1, 1, 0) and the madd ``exc`` flag included.

``launches`` counts kernel launches per kernel instance, ``widths`` the
lanes of each launch; only the CUDA branch of a wrapper increments them.
``SOURCES`` names the ``csrc/`` translation unit each kernel is built
from, ``REPLACES`` the pallas_call it replaces.
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from . import fold_mul
from .limbs import FQ, FR, device_of, spec_for

MODES = ("loop", "v1", "fold")
# the curve kernels K2-K6, K3d and K1's Fermat chain, by their loop names:
# each has an instance in every mode
CURVE_KERNELS = (
    "mont_inv_fq", "mont_inv_fr", "g1_madd", "g2_madd", "g1_madd_scan", "g2_madd_scan",
    "g1_add", "g2_add", "g1_add_shift", "g2_add_shift", "g1_add_distinct", "g2_add_distinct",
    "g1_double", "g2_double", "g1_addx", "g2_addx", "g1_window_sum", "g2_window_sum",
)
KERNELS = (
    "mont_mul_fq", "mont_mul_fr", "g1_madd", "g2_madd",
    "g1_add", "g2_add", "g1_double", "g2_double",
    "g1_add_distinct", "g2_add_distinct",
    "mont_mul_fq_v1", "mont_mul_fr_v1", "mont_mul_fq_fold", "mont_mul_fr_fold",
    "g1_addx", "g2_addx", "mont_inv_fq", "mont_inv_fr",
    "g1_madd_scan", "g2_madd_scan", "g1_add_shift", "g2_add_shift", "g1_window_sum", "g2_window_sum",
    *(f"{k}_{mode}" for mode in MODES[1:] for k in CURVE_KERNELS),
)


def instance(kernel: str, mode: str) -> str:
    """The name of `kernel`'s (its loop name's) instance in `mode`."""
    return kernel if mode == "loop" else f"{kernel}_{mode}"


def mode_of(name: str) -> str:
    """The multiplier mode of the kernel instance `name`."""
    return next((m for m in MODES[1:] if name.endswith(f"_{m}")), "loop")


def mul_mode() -> str:
    """The process's multiplier mode, read from ``VSTPU_MUL`` at each call
    as ``pallas_field._mul_mode`` reads it (unset: ``loop``); ValueError on
    a value that names no mode."""
    mode = os.environ.get("VSTPU_MUL", "loop")
    if mode not in MODES:
        raise ValueError(f"VSTPU_MUL={mode!r} names no multiplier mode (one of {MODES})")
    return mode


def _mode(mode: str | None) -> str:
    mode = mul_mode() if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"unknown multiplier mode {mode!r}")
    return mode

# file:line of the pallas_call each instance replaces
REPLACES = {
    "mont_mul_fq": "vote_saver_tpu/ops/pallas_field.py:786",
    "mont_mul_fr": "vote_saver_tpu/ops/pallas_field.py:786",
    "g1_madd": "vote_saver_tpu/ops/pallas_field.py:890",
    "g2_madd": "vote_saver_tpu/ops/pallas_field.py:923",
    "g1_add": "vote_saver_tpu/ops/pallas_field.py:517",
    "g2_add": "vote_saver_tpu/ops/pallas_field.py:570",
    "g1_double": "vote_saver_tpu/ops/pallas_field.py:542",
    "g2_double": "vote_saver_tpu/ops/pallas_field.py:597",
    "g1_add_distinct": "vote_saver_tpu/ops/pallas_field.py:517",
    "g2_add_distinct": "vote_saver_tpu/ops/pallas_field.py:570",
    "mont_mul_fq_v1": "vote_saver_tpu/ops/pallas_field.py:786",
    "mont_mul_fr_v1": "vote_saver_tpu/ops/pallas_field.py:786",
    "mont_mul_fq_fold": "vote_saver_tpu/ops/pallas_field.py:786",
    "mont_mul_fr_fold": "vote_saver_tpu/ops/pallas_field.py:786",
    "g1_addx": "vote_saver_tpu/ops/pallas_field.py:626",
    "g2_addx": "vote_saver_tpu/ops/pallas_field.py:656",
    # the K1 call that FieldOps.inv's scan (vote_saver_tpu/ops/field_ops.py:221) repeats
    "mont_inv_fq": "vote_saver_tpu/ops/pallas_field.py:786",
    "mont_inv_fr": "vote_saver_tpu/ops/pallas_field.py:786",
    # the K2 call that _msm_device's row scan (vote_saver_tpu/ops/msm_sched.py:543-553) repeats
    "g1_madd_scan": "vote_saver_tpu/ops/pallas_field.py:890",
    "g2_madd_scan": "vote_saver_tpu/ops/pallas_field.py:923",
    # the K3 call of _suffix_and_total's rounds (vote_saver_tpu/ops/msm_sched.py:492-505)
    "g1_add_shift": "vote_saver_tpu/ops/pallas_field.py:517",
    "g2_add_shift": "vote_saver_tpu/ops/pallas_field.py:570",
    # the K3d call that FixedBaseTable.mul's window sum (vote_saver_tpu/ops/msm.py:86-92) repeats
    "g1_window_sum": "vote_saver_tpu/ops/pallas_field.py:517",
    "g2_window_sum": "vote_saver_tpu/ops/pallas_field.py:570",
}
# v1 and fold: the pallas_call of the loop instance, compiled in that mode
REPLACES.update({instance(k, mode): REPLACES[k] for mode in MODES[1:] for k in CURVE_KERNELS})
# the csrc/ translation unit each kernel is built from
SOURCES = dict.fromkeys(KERNELS, "vote_saver_tpu_torch/csrc/kernels.cu")
SOURCES["g2_add"] = "vote_saver_tpu_torch/csrc/add_team.cu"
SOURCES.update(dict.fromkeys(("g1_add_distinct", "g2_add_distinct", "g1_addx", "g2_addx", "g1_window_sum",
                              "g2_window_sum"),
                             "vote_saver_tpu_torch/csrc/add_distinct.cu"))
SOURCES.update(dict.fromkeys(("mont_mul_fq_v1", "mont_mul_fr_v1", "mont_mul_fq_fold", "mont_mul_fr_fold"),
                             "vote_saver_tpu_torch/csrc/mont_mul_modes.cu"))
SOURCES.update({instance(k, mode): f"vote_saver_tpu_torch/csrc/curve_{mode}.cu"
                for mode in MODES[1:] for k in CURVE_KERNELS})
launches = dict.fromkeys(KERNELS, 0)
widths = {k: Counter() for k in KERNELS}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        widths[k].clear()


def _count(name: str, lanes: int) -> None:
    """One launch of kernel `name` over `lanes` lanes."""
    launches[name] += 1
    widths[name][lanes] += 1


# ---------------------------------------------------------------------------
# Plain arithmetic on 16-bit half-limbs (int64 tensors (..., H), H = 2L)
# ---------------------------------------------------------------------------

_M16 = 0xFFFF


def _half(x: torch.Tensor) -> torch.Tensor:
    """int32 (..., L) 32-bit limbs -> int64 (..., 2L) 16-bit limbs."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((x & _M16, x >> 16), dim=-1).flatten(-2)


def _pack(h: torch.Tensor) -> torch.Tensor:
    """int64 (..., 2L) canonical 16-bit limbs -> int32 (..., L) bit patterns."""
    v = h[..., 0::2] | (h[..., 1::2] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _chain_source(brk: torch.Tensor) -> torch.Tensor:
    """Index of the last True in brk at or before each position (-1: none)."""
    ar = torch.arange(brk.shape[-1], device=brk.device)
    return torch.cummax(torch.where(brk, ar, -1), dim=-1).values


def _resolve_carries(c: torch.Tensor):
    """Limbs in [0, 2^17 - 2] -> (canonical 16-bit limbs, carry out).

    Each limb carries at most one into the next; a carry passes through a
    limb exactly when it is 0xFFFF, so the carry out of limb k is the
    generate bit of the last limb at or before k that is not 0xFFFF."""
    last = _chain_source(c != _M16)
    gen = torch.gather(c >> 16, -1, last.clamp(min=0)) * (last >= 0)
    cin = F.pad(gen[..., :-1], (1, 0))
    return (c + cin) & _M16, gen[..., -1]


def _resolve_borrows(d: torch.Tensor):
    """Limb differences in (-2^16, 2^16) -> (16-bit limbs mod 2^16K, borrow out)."""
    last = _chain_source(d != 0)
    gen = torch.gather((d < 0).to(torch.int64), -1, last.clamp(min=0)) * (last >= 0)
    bin_ = F.pad(gen[..., :-1], (1, 0))
    return (d - bin_) & _M16, gen[..., -1]


def _normalize(c: torch.Tensor) -> torch.Tensor:
    """Non-negative lazy columns (< 2^40) -> canonical 16-bit limbs; carries
    out of the top column are dropped (the value is taken mod 2^16K)."""
    for _ in range(3):
        c = (c & _M16) + F.pad((c >> 16)[..., :-1], (1, 0))
    return _resolve_carries(c)[0]


class HalfField:
    """Montgomery arithmetic for one prime field on (..., H) 16-bit limbs.

    R = 2^(16H) equals the 32-bit layout's R (2^384 / 2^256), so a canonical
    Montgomery product here is the same value the CUDA kernel returns."""

    def __init__(self, spec):
        self.spec = spec
        H = self.H = 2 * spec.num_limbs
        R16 = 1 << (16 * H)
        self._n = self._limbs(spec.modulus)
        self._nprime = self._limbs((-pow(spec.modulus, -1, R16)) % R16)
        self._one = self._limbs(spec.to_mont(1))
        # (H*H, 2H + 1) 0/1 matrix summing product (i, j) into column i + j
        ij = (torch.arange(H)[:, None] + torch.arange(H)[None, :]).flatten()
        self._diag = torch.zeros(H * H, 2 * H + 1, dtype=torch.float64)
        self._diag[torch.arange(H * H), ij] = 1.0
        self._dev: dict = {}

    def _limbs(self, v: int) -> torch.Tensor:
        return torch.tensor([(v >> (16 * k)) & _M16 for k in range(self.H)], dtype=torch.int64)

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = getattr(self, name).to(device)
        return self._dev[key]

    def _columns(self, a, b):
        """Schoolbook product columns (..., 2H + 1), each < H * 2^32.

        float64 is exact here: every product is < 2^32 and every column sum
        of H <= 24 of them < 2^37, far inside the 53-bit mantissa."""
        p = (a.to(torch.float64)[..., :, None] * b.to(torch.float64)[..., None, :]).flatten(-2)
        return (p @ self._const("_diag", p.device)).to(torch.int64)

    def _csub(self, x):
        """(..., H + 1) limbs of a value < 2N -> (..., H) canonical."""
        n = F.pad(self._const("_n", x.device), (0, 1))
        d, borrow = _resolve_borrows(x - n)
        return torch.where((borrow == 0)[..., None], d, x)[..., : self.H]

    def redc(self, cols):
        """Montgomery-reduce lazy columns (..., <= 2H + 1), value < R*N."""
        H = self.H
        cols = F.pad(cols, (0, 2 * H + 1 - cols.shape[-1]))
        t = _normalize(cols)
        m = _normalize(self._columns(t[..., :H], self._const("_nprime", t.device))[..., :H])
        u = _normalize(t + self._columns(m, self._const("_n", t.device)))
        return self._csub(u[..., H:])

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self.redc(self._columns(a, b))

    def sq(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        s, carry = _resolve_carries(a + b)
        return self._csub(torch.cat([s, carry[..., None]], dim=-1))

    def sub(self, a, b):
        d, borrow = _resolve_borrows(a - b)
        fixed, _ = _resolve_carries(d + self._const("_n", d.device))
        return torch.where((borrow == 1)[..., None], fixed, d)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None], a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self._const("_one", a.device).expand_as(a).clone()


class HalfField2:
    """Fq2 = Fq[u]/(u^2 + 1) on (..., 2, H), exactly as ``Fq2Emit``."""

    def __init__(self, fq: HalfField):
        self.fq = fq

    def mul(self, a, b):
        f = self.fq
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        t = f.mul(
            torch.stack([a0, a1, f.add(a0, a1)], dim=-2),
            torch.stack([b0, b1, f.add(b0, b1)], dim=-2),
        )
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        return torch.stack([f.sub(t0, t1), f.sub(t2, f.add(t0, t1))], dim=-2)

    def sq(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t = f.mul(torch.stack([f.add(a0, a1), a0], dim=-2), torch.stack([f.sub(a0, a1), a1], dim=-2))
        t0, t1 = t[..., 0, :], t[..., 1, :]
        return torch.stack([t0, f.add(t1, t1)], dim=-2)

    def add(self, a, b):
        return self.fq.add(a, b)

    def sub(self, a, b):
        return self.fq.sub(a, b)

    def is_zero(self, a):
        return (a == 0).all(dim=-1).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        out = torch.zeros_like(a)
        out[..., 0, :] = self.fq.one_like(a[..., 0, :])
        return out


HALF = {"fq": HalfField(FQ), "fr": HalfField(FR)}
HALF_FQ2 = HalfField2(HALF["fq"])


# ---------------------------------------------------------------------------
# Group-law formulas over a field object — the pallas_field formulas with the
# same select order (shared by G1/Fq and G2/Fq2).
# ---------------------------------------------------------------------------


def jac_double(f, p):
    x1, y1, z1 = p
    a = f.sq(x1)
    b = f.sq(y1)
    c = f.sq(b)
    d = f.sub(f.sq(f.add(x1, b)), f.add(a, c))
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    ff = f.sq(e)
    x3 = f.sub(ff, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(f.add(y1, y1), z1)
    return (x3, y3, z3)


def _jac_add_generic(f, p, q):
    """The generic add's (x3, y3, z3) on every lane, with h and r."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = f.sq(z1)
    z2z2 = f.sq(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(f.mul(y1, z2), z2z2)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    h = f.sub(u2, u1)
    rr = f.sub(s2, s1)
    rr = f.add(rr, rr)
    i = f.sq(f.add(h, h))
    j = f.mul(h, i)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.sq(rr), j), f.add(v, v))
    s1j = f.mul(s1, j)
    y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.add(s1j, s1j))
    z3 = f.mul(f.sub(f.sq(f.add(z1, z2)), f.add(z1z1, z2z2)), h)
    return (x3, y3, z3), h, rr


def jac_add(f, p, q, complete: bool = True):
    """Jacobian add, as ``_jac_add(..., complete)``: complete=False keeps
    only the two infinity selects (h = 0 then gives the formula's own
    (x3, y3, 0), not canonical infinity)."""
    out, h, rr = _jac_add_generic(f, p, q)
    x1 = p[0]
    p_inf = f.is_zero(p[2])
    q_inf = f.is_zero(q[2])
    if complete:
        h_zero = f.is_zero(h)
        r_zero = f.is_zero(rr)
        same = h_zero & r_zero & ~p_inf & ~q_inf
        opposite = h_zero & ~r_zero & ~p_inf & ~q_inf
        dbl = jac_double(f, p)
        one = f.one_like(x1)
        inf = (one, one, f.zero_like(x1))
        out = tuple(f.select(same, d, g) for d, g in zip(dbl, out))
        out = tuple(f.select(opposite, iz, o) for iz, o in zip(inf, out))
    out = tuple(f.select(p_inf, qq, o) for qq, o in zip(q, out))
    out = tuple(f.select(q_inf & ~p_inf, pp, o) for pp, o in zip(p, out))
    return out


def jac_addx(f, p, q):
    """``_jac_addx``: the distinct add's selects plus the doubling-corner
    flag exc = (h = 0, r = 0, both finite)."""
    out, h, rr = _jac_add_generic(f, p, q)
    p_inf = f.is_zero(p[2])
    q_inf = f.is_zero(q[2])
    exc = f.is_zero(h) & f.is_zero(rr) & ~p_inf & ~q_inf
    out = tuple(f.select(p_inf, qq, o) for qq, o in zip(q, out))
    out = tuple(f.select(q_inf & ~p_inf, pp, o) for pp, o in zip(p, out))
    return out, exc


def jac_madd(f, acc, q, sign, active):
    """acc (Jacobian) += (-1)^sign * q (affine) where active (``_jac_madd``).

    (0, 0) q is inactive; an infinite acc lifts q; h == 0, r != 0 gives
    infinity; h == 0, r == 0 (the doubling corner) is flagged in exc."""
    x1, y1, z1 = acc
    x2, y2 = q
    active = active & ~(f.is_zero(x2) & f.is_zero(y2))
    y2 = f.select(sign, f.sub(f.zero_like(y2), y2), y2)
    z1z1 = f.sq(z1)
    u2 = f.mul(x2, z1z1)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    h = f.sub(u2, x1)
    hh = f.sq(h)
    i = f.add(hh, hh)
    i = f.add(i, i)
    j = f.mul(h, i)
    r = f.sub(s2, y1)
    r = f.add(r, r)
    v = f.mul(x1, i)
    x3 = f.sub(f.sub(f.sq(r), j), f.add(v, v))
    y1j = f.mul(y1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(y1j, y1j))
    z3 = f.sub(f.sub(f.sq(f.add(z1, h)), z1z1), hh)
    out = (x3, y3, z3)
    p_inf = f.is_zero(z1)
    h_zero = f.is_zero(h)
    r_zero = f.is_zero(r)
    one = f.one_like(x1)
    out = tuple(f.select(p_inf, lq, o) for lq, o in zip((x2, y2, one), out))
    inf = (one, one, f.zero_like(x1))
    out = tuple(f.select(h_zero & ~r_zero & ~p_inf, iz, o) for iz, o in zip(inf, out))
    exc = h_zero & r_zero & ~p_inf & active
    out = tuple(f.select(active, o, a) for o, a in zip(out, acc))
    return out, exc


# ---------------------------------------------------------------------------
# Plain versions on the public layout
# ---------------------------------------------------------------------------


def _field(g2: bool):
    return HALF_FQ2 if g2 else HALF["fq"]


def mont_mul_plain(name: str, a, b, mode: str = "loop"):
    """loop and v1 compute the same function: one separated product and
    REDC on 16-bit half-limbs; fold runs the fold pipeline."""
    if mode == "fold":
        return fold_mul.mul_fold_plain(spec_for(name), a, b)
    if mode not in MODES:
        raise ValueError(f"unknown multiplier mode {mode!r}")
    return _pack(HALF[name].mul(_half(a), _half(b)))


def inv_bits(name: str) -> list[int]:
    """The bits of N - 2, MSB first: the Fermat inversion's exponent."""
    return [int(b) for b in bin(spec_for(name).modulus - 2)[2:]]


def mont_inv_plain(name: str, a):
    """k_mont_inv's chain over HALF[name].mul: the top bit of N - 2 seeds
    the result with a, then one square per further bit and one multiply by
    a per set bit."""
    f, h = HALF[name], _half(a)
    res = h
    for bit in inv_bits(name)[1:]:
        res = f.sq(res)
        if bit:
            res = f.mul(res, h)
    return _pack(res)


def madd_plain(g2: bool, acc, q_affine, sign, active):
    """Inactive lanes keep acc with exc 0, so only active lanes are computed."""
    live = torch.nonzero(active.to(torch.bool)).flatten()
    out = tuple(c.clone() for c in acc)
    exc = torch.zeros(acc[0].shape[:1], dtype=torch.int32, device=acc[0].device)
    if live.numel():
        sub, e = jac_madd(
            _field(g2), tuple(_half(c[live]) for c in acc), tuple(_half(c[live]) for c in q_affine),
            sign.to(torch.bool)[live], torch.ones_like(live, dtype=torch.bool),
        )
        for o, c in zip(out, sub):
            o[live] = _pack(c)
        exc[live] = e.to(torch.int32)
    return out, exc


def add_plain(g2: bool, p, q):
    return tuple(_pack(c) for c in jac_add(_field(g2), tuple(map(_half, p)), tuple(map(_half, q))))


def add_distinct_plain(g2: bool, p, q):
    return tuple(_pack(c) for c in jac_add(_field(g2), tuple(map(_half, p)), tuple(map(_half, q)),
                                           complete=False))


def addx_plain(g2: bool, p, q):
    """-> (coords, (n,) int32 exc)."""
    out, exc = jac_addx(_field(g2), tuple(map(_half, p)), tuple(map(_half, q)))
    return tuple(_pack(c) for c in out), exc.to(torch.int32)


def double_plain(g2: bool, p, times: int = 1):
    p = tuple(map(_half, p))
    for _ in range(times):
        p = jac_double(_field(g2), p)
    return tuple(map(_pack, p))


def _infinity(g2: bool, lead: tuple, device):
    """Canonical infinity (1, 1, 0) as int32 limbs with leading dims `lead`."""
    L = FQ.num_limbs
    x = torch.zeros(tuple(lead) + ((2, L) if g2 else (L,)), dtype=torch.int32, device=device)
    one = _pack(HALF["fq"]._const("_one", device))
    if g2:
        x[..., 0, :] = one
    else:
        x[...] = one
    return (x, x.clone(), torch.zeros_like(x))


_IDX_MASK = (1 << 30) - 1


def check_codes(codes, npts: int) -> None:
    """IndexError where a scan code (a tensor or a numpy array) names a
    point past a table of `npts`: the kernel reads the table unchecked, and
    a gather past it on the card is a device-side assert.  On a CUDA tensor
    the check is one reduction read back on the host, so the vote path
    checks its codes on the host before they go up
    (``msm_sched.bucket_phase``) and tells the scan so."""
    if isinstance(codes, torch.Tensor):
        top = int((codes & _IDX_MASK).max()) if codes.numel() else 0
    elif codes.size:  # row by row, so the masked copy stays in cache
        buf = np.empty(codes.shape[-1], np.int32)
        top = max(int(np.bitwise_and(row, _IDX_MASK, out=buf).max()) for row in codes.reshape(-1, codes.shape[-1]))
    else:
        top = 0
    if top > npts:
        raise IndexError(f"a code names a point past the table of {npts}")


def madd_scan_plain(g2: bool, points_xy, codes):
    """The bucket scan as the row loop it replaces: from canonical infinity,
    one madd_plain per row of `codes` ((steps, lanes) int32: 0 idle, else
    (pidx + 1) | sign << 30) on the gathered points; exc is the OR of the
    rows' flags.  A code naming a point past the table raises IndexError."""
    px, py = points_xy
    check_codes(codes, px.shape[0])
    lanes = codes.shape[1]
    acc = _infinity(g2, (lanes,), px.device)
    exc = torch.zeros((lanes,), dtype=torch.int32, device=px.device)
    for row in codes:
        active = row != 0
        sign = ((row >> 30) & 1) != 0
        pidx = ((row & _IDX_MASK) - 1).clamp(min=0)
        acc, e = madd_plain(g2, acc, (px.index_select(0, pidx), py.index_select(0, pidx)), sign, active)
        exc |= e
    return acc, exc


def shift_partner(coords, shift: int, inf):
    """The suffix round's partners over a (rows, bw, ...) grid: coords[w, b
    + shift] where b + shift < bw, else `inf` (coordinates of the grid's
    shape)."""
    bw = coords[0].shape[1]
    valid = (torch.arange(bw, device=coords[0].device) + shift < bw).reshape((1, bw) + (1,) * (coords[0].dim() - 2))
    return tuple(torch.where(valid, torch.roll(c, -shift, dims=1), i) for c, i in zip(coords, inf))


def add_shift_plain(g2: bool, coords, shift: int):
    """One suffix round as the combination phase ran it before k_add_shift:
    the partners rolled in, canonical infinity past the window's end, then
    add_plain."""
    inf = _infinity(g2, tuple(coords[0].shape[:2]), coords[0].device)
    return add_plain(g2, coords, shift_partner(coords, shift, inf))


def tree_sum(adder, p, axis: int):
    """Hillis-Steele sum of points over `axis`: step s adds points[i + 2^s]
    into points[i] (lanes past the end keep their value); index 0 ends with
    the total."""
    coords = tuple(torch.movedim(c, axis, 0) for c in p)
    n = coords[0].shape[0]
    if n == 1:
        return tuple(c[0] for c in coords)
    idx = torch.arange(n, device=coords[0].device)
    for s in range((n - 1).bit_length()):
        shift = 1 << s
        shifted = tuple(torch.roll(c, -shift, dims=0) for c in coords)
        added = adder(coords, shifted)
        valid = (idx + shift < n).reshape((n,) + (1,) * (coords[0].dim() - 1))
        coords = tuple(torch.where(valid, a, c) for a, c in zip(added, coords))
    return tuple(c[0] for c in coords)


def check_window_digits(digits, entries: int) -> None:
    """IndexError where a window digit (a tensor or a numpy array) is not
    an entry of a table row of `entries`: the kernel reads the table
    unchecked.  On a CUDA tensor the check is a reduction read back on the
    host, so FixedBaseTable.mul checks its digits on the host first."""
    empty = digits.size == 0 if isinstance(digits, np.ndarray) else digits.numel() == 0
    if not empty and (int(digits.min()) < 0 or int(digits.max()) >= entries):
        raise IndexError(f"a window digit is not an entry of the table's {entries}")


def window_sum_plain(g2: bool, table, digits):
    """FixedBaseTable.mul's window sum as it ran before k_window_sum: the
    (W, n) gather table[w][digits[:, w]] of the Jacobian table (W, E, ...)
    x3, then the Hillis-Steele sum over the windows by add_distinct_plain;
    a digit past a row raises IndexError."""
    check_window_digits(digits, table[0].shape[1])
    d = torch.as_tensor(digits, device=table[0].device).to(torch.int64)
    rows = torch.arange(table[0].shape[0], device=d.device)[:, None]
    gathered = tuple(c[rows, d.T] for c in table)
    return tree_sum(lambda p, q: add_distinct_plain(g2, p, q), gathered, 0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_L = FQ.num_limbs


def _lib():
    from . import _build

    return _build.load().lib


def _launcher(fn: str, mode: str, device):
    """The extern "C" launcher `fn` (its loop name) of `mode`'s unit, with
    the fold unit's matrices in place on `device` before its first launch
    there: the dp4a fold's of Fq in its __constant__ memory (its dp4a
    instances are all Fq's), the tensor-core fold's B operands of Fq and Fr
    (``MMA_KERNELS``) in its device memory.  A missing launcher raises
    AttributeError."""
    lib = _lib()
    if mode == "loop":
        return getattr(lib, fn)
    if mode == "fold":
        upload_fold_matrix(lib.vs_curve_fold_upload, 0, device)
        for field in (0, 1):
            upload_fold_matrix(lib.vs_curve_fold_mma_upload, field, device, pack=fold_mul.mma_operand)
    return getattr(lib, f"{fn}_{mode}")


# the instances whose multiply runs its fold product on the int8 tensor
# cores (csrc/curve_fold.cu: Called<MulFoldMma> in G1, MulFoldMma in G2,
# the G2 team add and the Fq inversion chain, MulFoldMmaOf<FrParams> in the
# Fr inversion chain, a warp's lanes as one tile of mma.sync), in the order
# of vs_curve_fold_mma_info's kernel index; the fold unit's other instances
# (the single-row madd, the distinct and flagged adds) keep the dp4a fold
MMA_KERNELS = ("g1_madd_scan_fold", "g1_double_fold", "g1_add_shift_fold", "g2_double_fold",
               "g2_madd_scan_fold", "g2_add_shift_fold", "g1_add_fold", "mont_inv_fr_fold",
               "mont_inv_fq_fold", "g2_add_fold")


def kernel_info(entry, index: int, name: str, device="cuda") -> dict:
    """What the CUDA runtime reports of kernel `index` of the info entry
    `entry` (``vs_mul_chain_info``, ``vs_curve_fold_mma_info``; csrc
    fold_mma.cuh's kernel_info) on `device`: registers and local (spill and
    stack) bytes a thread, shared memory a block (dynamic and static), and
    the blocks and warps resident on one SM.  `name` labels an error."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_of(device)):
        rc = entry(index, ctypes.addressof(out))
    _raise_on(rc, f"{name} info")
    regs, local, smem, blocks, threads = out
    return dict(registers=regs, local_bytes=local, smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32)


def mma_info(name: str, device="cuda") -> dict:
    """kernel_info of the tensor-core instance `name` (``MMA_KERNELS``)."""
    return kernel_info(_lib().vs_curve_fold_mma_info, MMA_KERNELS.index(name), name, device)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check(coords, tail: tuple, n: int, device) -> None:
    for c in coords:
        if c.dtype != torch.int32 or c.device != device:
            raise ValueError(f"expected int32 limbs on {device}, got {c.dtype} on {c.device}")
        if tuple(c.shape) != (n,) + tail or not c.is_contiguous():
            raise ValueError(f"expected contiguous shape {(n,) + tail}, got {tuple(c.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _flat(coords, tail_dims: int):
    """Broadcast coords to one shape and flatten the leading dims."""
    coords = torch.broadcast_tensors(*coords)
    shape = coords[0].shape
    lead = shape[: len(shape) - tail_dims]
    n = 1
    for s in lead:
        n *= s
    flat = tuple(c.reshape((n,) + tuple(shape[len(lead):])).contiguous() for c in coords)
    return flat, shape, n


# (upload function, field, device index) whose fold matrix is in place
_fold_uploaded: set = set()


def upload_fold_matrix(upload, field: int, device, pack=fold_mul.packed_matrix) -> None:
    """Copy field's fold matrix, in the layout `pack` gives it (``packed_matrix``
    for the dp4a fold's __constant__ memory, ``mma_operand`` for the
    tensor-core fold's B operand), into the library whose upload function is
    `upload`, once per device."""
    key = (upload.__name__, field, device.index)
    if key in _fold_uploaded:
        return
    arr = pack(FQ if field == 0 else FR)
    with torch.cuda.device(device):
        _raise_on(upload(field, arr.ctypes.data, arr.size), "fold matrix upload")
    _fold_uploaded.add(key)


def mul_operands(a: torch.Tensor, b: torch.Tensor):
    """K1's operands as its kernel reads them: (x (n, L), y (nb, L), the
    product's shape, n, nb), lane i of the product being x[i] * y[i % nb].
    Where one operand's leading dims, leading 1s dropped, are a suffix of
    the other's (a table broadcast over the batch: twiddles, COO
    coefficients, a constant), that operand is y and keeps its nb lanes
    (the product commutes, limb for limb); otherwise both are broadcast and
    materialised, nb = n."""
    L = a.shape[-1]
    for x, y in ((a, b), (b, a)):
        xs, ys = x.shape[:-1], y.shape[:-1]
        while ys and ys[0] == 1:
            ys = ys[1:]
        if y.shape[-1] == L and len(ys) <= len(xs) and xs[len(xs) - len(ys):] == ys:
            n, nb = x.numel() // L, y.numel() // L
            return x.reshape(n, L).contiguous(), y.reshape(nb, L).contiguous(), x.shape, n, nb
    (a, b), shape, n = _flat((a, b), 1)
    return a, b, shape, n, n


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernel moves lanes as uint4)."""
    return t.clone() if t.data_ptr() % 16 else t


def mont_mul(name: str, a: torch.Tensor, b: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """K1: Montgomery a*b*R^-1 mod p on (..., L) limbs ('fq' or 'fr'), with
    the multiplier `mode` ('loop', 'v1' or 'fold'; None: ``mul_mode()``).
    In ``loop`` an operand broadcast over the other's leading dims is read
    in place (``mul_operands``); the other modes materialise it."""
    mode = _mode(mode)
    field = 0 if name == "fq" else 1
    kname = instance(f"mont_mul_{name}", mode)
    L = spec_for(name).num_limbs
    if mode == "loop":
        x, y, shape, n, nb = mul_operands(a, b)
        if not _on_cuda(a):
            return mont_mul_plain(name, x, y.index_select(0, torch.arange(n) % max(nb, 1))).reshape(shape)
        if x.dtype != torch.int32 or y.dtype != torch.int32 or y.device != x.device or x.shape[-1] != L:
            raise ValueError(f"expected int32 (..., {L}) limbs on one device, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device} and {y.dtype} {tuple(y.shape)} on {y.device}")
        x, y = _aligned16(x), _aligned16(y)
        out = torch.empty_like(x)
        if n:
            rc = _lib().vs_mont_mul(field, x.data_ptr(), y.data_ptr(), out.data_ptr(), n, nb, _stream(x.device))
            _raise_on(rc, kname)
            _count(kname, n)
        return out.reshape(shape)
    if not _on_cuda(a):
        return mont_mul_plain(name, a, b, mode)
    (a, b), shape, n = _flat((a, b), 1)
    _check((a, b), (L,), n, a.device)
    out = torch.empty_like(a)
    if n:
        lib = _lib()
        if mode == "fold":
            upload_fold_matrix(lib.vs_mont_mul_fold_upload, field, a.device)
        rc = lib.vs_mont_mul_mode(field, MODES.index(mode), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  n, _stream(a.device))
        _raise_on(rc, kname)
        _count(kname, n)
    return out.reshape(shape)


def mont_inv(name: str, a: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """K1's Fermat chain: a^(N-2) on (..., L) Montgomery limbs ('fq' or
    'fr') in one launch, its multiplies in `mode`; 0 maps to 0 (callers
    mask zeros)."""
    mode = _mode(mode)
    if not _on_cuda(a):
        return mont_inv_plain(name, a)
    L = spec_for(name).num_limbs
    (a,), shape, n = _flat((a,), 1)
    _check((a,), (L,), n, a.device)
    out = torch.empty_like(a)
    kname = instance(f"mont_inv_{name}", mode)
    if n:
        rc = _launcher("vs_mont_inv", mode, a.device)(0 if name == "fq" else 1, a.data_ptr(), out.data_ptr(), n,
                                                      _stream(a.device))
        _raise_on(rc, kname)
        _count(kname, n)
    return out.reshape(shape)


def _madd(g2: bool, acc, q_affine, sign, active, out=None, mode=None):
    """K2.  ``out`` may be ``acc`` itself: each lane reads its inputs before
    it writes, so the bucket scan updates its accumulator in place."""
    mode = _mode(mode)
    if not _on_cuda(acc[0]):
        return madd_plain(g2, acc, q_affine, sign, active)
    tail = (2, _L) if g2 else (_L,)
    n = acc[0].shape[0]
    _check((*acc, *q_affine), tail, n, acc[0].device)
    sign = sign.to(torch.bool).contiguous()
    active = active.to(torch.bool).contiguous()
    if sign.shape != (n,) or active.shape != (n,) or sign.device != acc[0].device:
        raise ValueError("sign/active must be (B,) on the coordinates' device")
    out = tuple(torch.empty_like(c) for c in acc) if out is None else out
    _check(out, tail, n, acc[0].device)
    exc = torch.empty((n,), dtype=torch.int32, device=acc[0].device)
    name = instance("g2_madd" if g2 else "g1_madd", mode)
    if n:
        ptrs = [c.data_ptr() for c in (*acc, *q_affine, sign, active, *out, exc)]
        _raise_on(_launcher("vs_madd", mode, acc[0].device)(int(g2), *ptrs, n, _stream(acc[0].device)), name)
        _count(name, n)
    return out, exc


def g1_madd(acc, q_affine, sign, active, out=None, mode=None):
    """acc: Jacobian (B, L) x3; q_affine: (x, y) (B, L); sign/active (B,)
    bool -> ((B, L) x3, (B,) int32 doubling-corner flag)."""
    return _madd(False, acc, q_affine, sign, active, out, mode)


def g2_madd(acc, q_affine, sign, active, out=None, mode=None):
    """G2 variant: coords (B, 2, L)."""
    return _madd(True, acc, q_affine, sign, active, out, mode)


def _madd_scan(g2: bool, points_xy, codes, checked: bool, mode):
    mode = _mode(mode)
    px, py = points_xy
    if not _on_cuda(px):
        return madd_scan_plain(g2, points_xy, codes)
    tail = (2, _L) if g2 else (_L,)
    dev = px.device
    npts = px.shape[0]
    _check((px, py), tail, npts, dev)
    if codes.dtype != torch.int32 or codes.device != dev or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous (steps, lanes) int32 tensor on {dev}")
    if not checked:
        check_codes(codes, npts)
    steps, lanes = codes.shape
    out = tuple(torch.empty((lanes,) + tail, dtype=torch.int32, device=dev) for _ in range(3))
    exc = torch.empty((lanes,), dtype=torch.int32, device=dev)
    name = instance("g2_madd_scan" if g2 else "g1_madd_scan", mode)
    if lanes:
        ptrs = [t.data_ptr() for t in (*out, exc)]
        rc = _launcher("vs_madd_scan", mode, dev)(int(g2), px.data_ptr(), py.data_ptr(), codes.data_ptr(), steps,
                                                  lanes, *ptrs, _stream(dev))
        _raise_on(rc, name)
        _count(name, lanes)
    return out, exc


def g1_madd_scan(points_xy, codes, checked: bool = False, mode=None):
    """K2's bucket scan: points_xy (x, y) (n, L) affine, (0, 0) for
    infinity; codes (steps, lanes) int32 -> (Jacobian (lanes, L) x3, the
    (lanes,) int32 OR of each lane's doubling-corner flags).  A code naming
    no point of the table raises IndexError; ``checked=True`` says the
    caller has run ``check_codes`` on them already, and the kernel's
    wrapper then reads nothing back from the card."""
    return _madd_scan(False, points_xy, codes, checked, mode)


def g2_madd_scan(points_xy, codes, checked: bool = False, mode=None):
    """G2 variant: points (n, 2, L)."""
    return _madd_scan(True, points_xy, codes, checked, mode)


def _add_shift(g2: bool, coords, shift: int, out=None, mode=None):
    mode = _mode(mode)
    if int(shift) != shift or shift < 1:
        raise ValueError(f"shift must be an integer >= 1, got {shift!r}")
    if not _on_cuda(coords[0]):
        res = add_shift_plain(g2, coords, shift)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    tail = (2, _L) if g2 else (_L,)
    dev = coords[0].device
    coords = tuple(c.contiguous() for c in coords)
    rows, bw = coords[0].shape[:2]
    _check(coords, (bw,) + tail, rows, dev)
    out = tuple(torch.empty_like(c) for c in coords) if out is None else out
    _check(out, (bw,) + tail, rows, dev)
    if any(o.data_ptr() == c.data_ptr() for o in out for c in coords):
        raise ValueError("add_shift's output must not alias its input")
    name = instance("g2_add_shift" if g2 else "g1_add_shift", mode)
    if rows * bw:
        ptrs = [c.data_ptr() for c in (*coords, *out)]
        _raise_on(_launcher("vs_add_shift", mode, dev)(int(g2), *ptrs, rows * bw, bw, min(int(shift), bw),
                                                       _stream(dev)), name)
        _count(name, rows * bw)
    return out


def g1_add_shift(coords, shift: int, out=None, mode=None):
    """K3 as one suffix round over the (rows, bw, L) bucket grid:
    out[w, b] = add(in[w, b], in[w, b + shift] if b + shift < bw else
    infinity), complete; `out` (the same shape, not aliasing coords) is
    written and returned when given."""
    return _add_shift(False, coords, shift, out, mode)


def g2_add_shift(coords, shift: int, out=None, mode=None):
    """G2 variant: coords (rows, bw, 2, L)."""
    return _add_shift(True, coords, shift, out, mode)


def _add(g2: bool, p, q, complete: bool = True, mode=None):
    """K3 (K3d where not `complete`); G2's complete add is the team kernel."""
    mode = _mode(mode)
    if not _on_cuda(p[0]):
        return (add_plain if complete else add_distinct_plain)(g2, p, q)
    tail = (2, _L) if g2 else (_L,)
    coords, shape, n = _flat((*p, *q), len(tail))
    _check(coords, tail, n, coords[0].device)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    name = instance(("g2_add" if g2 else "g1_add") + ("" if complete else "_distinct"), mode)
    if n:
        if g2 and complete:
            coords = tuple(map(_aligned16, coords))
        ptrs = [c.data_ptr() for c in (*coords, *out)]
        dev = coords[0].device
        stream = _stream(dev)
        if not complete:
            rc = _launcher("vs_add_distinct", mode, dev)(int(g2), *ptrs, n, stream)
        else:
            rc = _launcher("vs_g2_add_team" if g2 else "vs_g1_add", mode, dev)(*ptrs, n, stream)
        _raise_on(rc, name)
        _count(name, n)
    return tuple(o.reshape(shape) for o in out)


def g1_add(p, q, mode=None):
    """K3: complete Jacobian add; coords (..., L), broadcast-compatible."""
    return _add(False, p, q, mode=mode)


def g2_add(p, q, mode=None):
    """K3 over Fq2; coords (..., 2, L): a team of 16 threads a lane
    (``csrc/add_team.cuh``)."""
    return _add(True, p, q, mode=mode)


def g1_add_distinct(p, q, mode=None):
    """K3d: distinct-operand Jacobian add (p != +-q where both are finite);
    coords (..., L), broadcast-compatible."""
    return _add(False, p, q, complete=False, mode=mode)


def g2_add_distinct(p, q, mode=None):
    """K3d over Fq2; coords (..., 2, L)."""
    return _add(True, p, q, complete=False, mode=mode)


# threads a window-sum output (k_window_sum's team; csrc kWindowTeam), in
# G1 and G2: the fastest of 1, 2, 4 and 8 on the card at the depth-6
# setup's widths (PERF.md).  The loop instance also takes 1, 2 and 8, which
# chip_smoke.py times beside it; v1 and fold take only this.
WINDOW_TEAM = 4
# k_window_sum's table: 32 windows of 8 bits
WINDOW_SHAPE = (32, 256)


def _window_sum(g2: bool, table, digits, checked: bool, mode, team):
    mode = _mode(mode)
    if not _on_cuda(table[0]):
        return window_sum_plain(g2, table, digits)
    team = WINDOW_TEAM if team is None else team
    if team not in ((1, 2, 4, 8) if mode == "loop" else (WINDOW_TEAM,)):
        raise ValueError(f"the {mode} window sum takes no team of {team!r} threads an output")
    tail = (2, _L) if g2 else (_L,)
    dev = table[0].device
    _check(table, WINDOW_SHAPE[1:] + tail, WINDOW_SHAPE[0], dev)
    table = tuple(map(_aligned16, table))
    if (digits.dtype != torch.int32 or digits.device != dev or digits.dim() != 2
            or digits.shape[1] != WINDOW_SHAPE[0] or not digits.is_contiguous()):
        raise ValueError(f"digits must be a contiguous (n, {WINDOW_SHAPE[0]}) int32 tensor on {dev}")
    if not checked:
        check_window_digits(digits, WINDOW_SHAPE[1])
    n = digits.shape[0]
    out = tuple(torch.empty((n,) + tail, dtype=torch.int32, device=dev) for _ in range(3))
    name = instance("g2_window_sum" if g2 else "g1_window_sum", mode)
    if n:
        ptrs = [t.data_ptr() for t in (*table, digits, *out)]
        _raise_on(_launcher("vs_window_sum", mode, dev)(int(g2), *ptrs, n, int(team), _stream(dev)), name)
        _count(name, n)
    return out


def g1_window_sum(table, digits, checked: bool = False, mode=None, team=None):
    """K3d as FixedBaseTable.mul's window sum: table (32, 256, L) x3
    Jacobian, entry 0 of each row infinity; digits (n, 32) int32, the LSB
    window first -> (n, L) x3, the sum of each row's 32 entries in the JAX
    scan's tree.  A digit past a row raises IndexError (``checked=True``:
    the caller has run ``check_window_digits``, so nothing is read back from
    the card).  `team`: threads an output, ``WINDOW_TEAM`` by default."""
    return _window_sum(False, table, digits, checked, mode, team)


def g2_window_sum(table, digits, checked: bool = False, mode=None, team=None):
    """G2 variant: table (32, 256, 2, L) x3 -> (n, 2, L) x3."""
    return _window_sum(True, table, digits, checked, mode, team)


def _addx(g2: bool, p, q, mode=None):
    mode = _mode(mode)
    if not _on_cuda(p[0]):
        return addx_plain(g2, p, q)
    tail = (2, _L) if g2 else (_L,)
    coords, shape, n = _flat((*p, *q), len(tail))
    _check(coords, tail, n, coords[0].device)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    exc = torch.empty((n,), dtype=torch.int32, device=coords[0].device)
    name = instance("g2_addx" if g2 else "g1_addx", mode)
    if n:
        ptrs = [c.data_ptr() for c in (*coords, *out, exc)]
        dev = coords[0].device
        _raise_on(_launcher("vs_addx", mode, dev)(int(g2), *ptrs, n, _stream(dev)), name)
        _count(name, n)
    lead = shape[: len(shape) - len(tail)]
    return tuple(o.reshape(shape) for o in out), exc.reshape(lead)


def g1_addx(p, q, mode=None):
    """K5: distinct add with the doubling-corner flag; coords (..., L),
    broadcast-compatible -> (coords, (...) int32 exc)."""
    return _addx(False, p, q, mode)


def g2_addx(p, q, mode=None):
    """K6: K5 over Fq2; coords (..., 2, L)."""
    return _addx(True, p, q, mode)


def _double(g2: bool, p, times: int, mode=None):
    mode = _mode(mode)
    if int(times) != times or times < 1:
        raise ValueError(f"times must be an integer >= 1, got {times!r}")
    if not _on_cuda(p[0]):
        return double_plain(g2, p, times)
    tail = (2, _L) if g2 else (_L,)
    coords, shape, n = _flat(p, len(tail))
    _check(coords, tail, n, coords[0].device)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    name = instance("g2_double" if g2 else "g1_double", mode)
    if n:
        ptrs = [c.data_ptr() for c in (*coords, *out)]
        dev = coords[0].device
        _raise_on(_launcher("vs_double", mode, dev)(int(g2), *ptrs, n, int(times), _stream(dev)), name)
        _count(name, n)
    return tuple(o.reshape(shape) for o in out)


def g1_double(p, times: int = 1, mode=None):
    """K4: `times` Jacobian doublings (a = 0) in one launch; coords (..., L)."""
    return _double(False, p, times, mode)


def g2_double(p, times: int = 1, mode=None):
    """K4 over Fq2; coords (..., 2, L)."""
    return _double(True, p, times, mode)
