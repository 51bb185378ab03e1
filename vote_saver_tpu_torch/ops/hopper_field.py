"""The four Hopper kernels of the slice, their wrappers and plain versions.

Counterpart of ``vote_saver_tpu/ops/pallas_field.py``.  Each public function
keeps the signature and layout of its Pallas entry point:

  K1 ``mont_mul(name, a, b)``                       <- mont_mul_pallas
  K2 ``g1_madd``/``g2_madd(acc, q_affine, sign, active) -> (acc', exc)``
                                                    <- g1/g2_madd_pallas
  K3 ``g1_add``/``g2_add(p, q)`` (complete)         <- g1/g2_add_pallas
  K4 ``g1_double``/``g2_double(p)``                 <- g1/g2_double_pallas

Coordinates are int32 tensors ``(..., L)`` (G1, Fq/Fr) or ``(..., 2, L)``
(G2) of 32-bit Montgomery limbs.  On a CUDA tensor a wrapper launches its
kernel from ``csrc/kernels.cu`` (or raises); on a CPU tensor it runs the
plain PyTorch version beside it.  The plain versions compute on int64
tensors of 16-bit half-limbs (CPU torch has no uint32/uint64 add, sub or
shift) with vectorised carry resolution, and follow the Pallas formulas'
select order exactly, so kernel and plain version agree limb for limb —
canonical infinity (1, 1, 0) and the madd ``exc`` flag included.

``launches`` counts kernel launches per kernel instance; only the CUDA
branch of a wrapper increments it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .limbs import FQ, FR, spec_for

KERNELS = (
    "mont_mul_fq", "mont_mul_fr", "g1_madd", "g2_madd",
    "g1_add", "g2_add", "g1_double", "g2_double",
)
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
}
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def jac_add(f, p, q):
    """Complete Jacobian add (``_jac_add(..., complete=True)``)."""
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
    out = (x3, y3, z3)
    p_inf = f.is_zero(z1)
    q_inf = f.is_zero(z2)
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


def mont_mul_plain(name: str, a, b):
    return _pack(HALF[name].mul(_half(a), _half(b)))


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


def double_plain(g2: bool, p):
    return tuple(_pack(c) for c in jac_double(_field(g2), tuple(map(_half, p))))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_L = FQ.num_limbs


def _lib():
    from . import _build

    return _build.load().lib


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


def mont_mul(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: Montgomery a*b*R^-1 mod p on (..., L) limbs ('fq' or 'fr')."""
    if not _on_cuda(a):
        return mont_mul_plain(name, a, b)
    L = spec_for(name).num_limbs
    (a, b), shape, n = _flat((a, b), 1)
    _check((a, b), (L,), n, a.device)
    out = torch.empty_like(a)
    if n:
        _raise_on(_lib().vs_mont_mul(0 if name == "fq" else 1, a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), n, _stream(a.device)), f"mont_mul_{name}")
        launches[f"mont_mul_{name}"] += 1
    return out.reshape(shape)


def _madd(g2: bool, acc, q_affine, sign, active, out=None):
    """K2.  ``out`` may be ``acc`` itself: each lane reads its inputs before
    it writes, so the bucket scan updates its accumulator in place."""
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
    name = "g2_madd" if g2 else "g1_madd"
    if n:
        ptrs = [c.data_ptr() for c in (*acc, *q_affine, sign, active, *out, exc)]
        _raise_on(_lib().vs_madd(int(g2), *ptrs, n, _stream(acc[0].device)), name)
        launches[name] += 1
    return out, exc


def g1_madd(acc, q_affine, sign, active, out=None):
    """acc: Jacobian (B, L) x3; q_affine: (x, y) (B, L); sign/active (B,)
    bool -> ((B, L) x3, (B,) int32 doubling-corner flag)."""
    return _madd(False, acc, q_affine, sign, active, out)


def g2_madd(acc, q_affine, sign, active, out=None):
    """G2 variant: coords (B, 2, L)."""
    return _madd(True, acc, q_affine, sign, active, out)


def _add(g2: bool, p, q):
    if not _on_cuda(p[0]):
        return add_plain(g2, p, q)
    tail = (2, _L) if g2 else (_L,)
    coords, shape, n = _flat((*p, *q), len(tail))
    _check(coords, tail, n, coords[0].device)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    name = "g2_add" if g2 else "g1_add"
    if n:
        ptrs = [c.data_ptr() for c in (*coords, *out)]
        _raise_on(_lib().vs_add(int(g2), *ptrs, n, _stream(coords[0].device)), name)
        launches[name] += 1
    return tuple(o.reshape(shape) for o in out)


def g1_add(p, q):
    """K3: complete Jacobian add; coords (..., L), broadcast-compatible."""
    return _add(False, p, q)


def g2_add(p, q):
    """K3 over Fq2; coords (..., 2, L)."""
    return _add(True, p, q)


def _double(g2: bool, p):
    if not _on_cuda(p[0]):
        return double_plain(g2, p)
    tail = (2, _L) if g2 else (_L,)
    coords, shape, n = _flat(p, len(tail))
    _check(coords, tail, n, coords[0].device)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    name = "g2_double" if g2 else "g1_double"
    if n:
        ptrs = [c.data_ptr() for c in (*coords, *out)]
        _raise_on(_lib().vs_double(int(g2), *ptrs, n, _stream(coords[0].device)), name)
        launches[name] += 1
    return tuple(o.reshape(shape) for o in out)


def g1_double(p):
    """K4: Jacobian doubling (a = 0); coords (..., L)."""
    return _double(False, p)


def g2_double(p):
    """K4 over Fq2; coords (..., 2, L)."""
    return _double(True, p)
