"""Host Jacobian-coordinate arithmetic + Pippenger MSM / fixed-base windows.

The CPU execution provider for CRS generation and proving MSMs: on the TPU
these run as device kernels (ops/msm.py); on CPU hosts the classic
sequential Pippenger over Python ints is faster than lane-parallel XLA, so
the protocol layer dispatches here when no TPU is present.  Also serves as
the reference implementation the device MSMs are tested against at scale.
"""

from __future__ import annotations

from ..params import Q, R
from . import field as f

# Field adapters: ops = (add, sub, mul, sq) closed over the coordinate field.
_FQ = (
    lambda a, b: (a + b) % Q,
    lambda a, b: (a - b) % Q,
    lambda a, b: a * b % Q,
    lambda a: a * a % Q,
)
_FQ2 = (f.fq2_add, f.fq2_sub, f.fq2_mul, f.fq2_sq)


def _ops(group: str):
    return _FQ if group == "g1" else _FQ2


# Jacobian points: (X, Y, Z); None = infinity.


def jac_from_affine(p):
    if p is None:
        return None
    return (p[0], p[1], 1 if isinstance(p[0], int) else f.FQ2_ONE)


def jac_double(p, group="g1"):
    if p is None:
        return None
    add, sub, mul, sq = _ops(group)
    x, y, z = p
    a = sq(x)
    b = sq(y)
    c = sq(b)
    d = sub(sq(add(x, b)), add(a, c))
    d = add(d, d)
    e = add(add(a, a), a)
    x3 = sub(sq(e), add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    y3 = sub(mul(e, sub(d, x3)), c8)
    z3 = mul(add(y, y), z)
    return (x3, y3, z3)


def jac_add(p, q, group="g1"):
    if p is None:
        return q
    if q is None:
        return p
    add, sub, mul, sq = _ops(group)
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = sq(z1)
    z2z2 = sq(z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    h = sub(u2, u1)
    rr = sub(s2, s1)
    zero = 0 if group == "g1" else f.FQ2_ZERO
    if h == zero:
        if rr == zero:
            return jac_double(p, group)
        return None
    rr = add(rr, rr)
    i = sq(add(h, h))
    j = mul(h, i)
    v = mul(u1, i)
    x3 = sub(sub(sq(rr), j), add(v, v))
    s1j = mul(s1, j)
    y3 = sub(mul(rr, sub(v, x3)), add(s1j, s1j))
    z3 = mul(sub(sq(add(z1, z2)), add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def jac_to_affine(p, group="g1"):
    if p is None:
        return None
    x, y, z = p
    if group == "g1":
        zi = pow(z, Q - 2, Q)
        zi2 = zi * zi % Q
        return (x * zi2 % Q, y * zi2 % Q * zi % Q)
    zi = f.fq2_inv(z)
    zi2 = f.fq2_sq(zi)
    return (f.fq2_mul(x, zi2), f.fq2_mul(y, f.fq2_mul(zi, zi2)))


def msm_host(points_affine, scalars, group="g1", window_bits: int = 8) -> tuple | None:
    """Pippenger MSM over host ints; returns an affine point or None.

    Dispatches to the native C++ kernel (native/vs_native.cpp) when built;
    the pure-Python path below doubles as its correctness oracle."""
    n = len(points_affine)
    assert n == len(scalars)
    from .. import native_bridge as nb

    if nb.available():
        return nb.msm(points_affine, scalars, group=group, window_bits=window_bits)
    pts = [jac_from_affine(p) for p in points_affine]
    num_windows = (255 + window_bits - 1) // window_bits
    mask = (1 << window_bits) - 1
    scalars = [int(s) % R for s in scalars]
    acc = None
    for w in range(num_windows - 1, -1, -1):
        for _ in range(window_bits):
            acc = jac_double(acc, group)
        buckets = [None] * (1 << window_bits)
        for p, s in zip(pts, scalars):
            d = (s >> (w * window_bits)) & mask
            if d and p is not None:
                buckets[d] = jac_add(buckets[d], p, group)
        running = None
        total = None
        for b in range(mask, 0, -1):
            running = jac_add(running, buckets[b], group)
            total = jac_add(total, running, group)
        acc = jac_add(acc, total, group)
    return jac_to_affine(acc, group)


class FixedBaseHost:
    """Host windowed fixed-base multiplier (8-bit windows, 31 adds/scalar);
    mul_many dispatches to the native C++ kernel when built."""

    def __init__(self, base_affine, group="g1", window_bits: int = 8):
        self.base_affine = base_affine
        self.group = group
        self.window_bits = window_bits
        self.num_windows = (255 + window_bits - 1) // window_bits
        self.mask = (1 << window_bits) - 1
        self._table = None  # built lazily (unneeded when native dispatch hits)

    @property
    def table(self):
        if self._table is None:
            self._table = []
            win_base = jac_from_affine(self.base_affine)
            for _ in range(self.num_windows):
                row = [None]
                for _ in range(1, 1 << self.window_bits):
                    row.append(jac_add(row[-1], win_base, self.group))
                self._table.append(row)
                for _ in range(self.window_bits):
                    win_base = jac_double(win_base, self.group)
        return self._table

    def mul(self, scalar: int):
        acc = None
        s = int(scalar) % R
        for w in range(self.num_windows):
            d = (s >> (w * self.window_bits)) & self.mask
            acc = jac_add(acc, self.table[w][d], self.group)
        return jac_to_affine(acc, self.group)

    def mul_many(self, scalars):
        from .. import native_bridge as nb

        if nb.available():
            return nb.fixed_base(self.base_affine, scalars, group=self.group,
                                 window_bits=self.window_bits)
        return [self.mul(s) for s in scalars]


def g1_mul_many(points_affine, scalars) -> list:
    """Pointwise k_i * P_i over G1 (native-accelerated when built)."""
    from .. import native_bridge as nb
    from . import curves as rc

    if nb.available():
        return nb.g1_mul_many(points_affine, scalars)
    return [rc.g1_mul(p, k) if p is not None else None
            for p, k in zip(points_affine, scalars)]


def g2_mul_many(points_affine, scalars) -> list:
    """Pointwise k_i * Q_i over G2 (native-accelerated when built)."""
    from .. import native_bridge as nb
    from . import curves as rc

    if nb.available():
        return nb.g2_mul_many(points_affine, scalars)
    return [rc.g2_mul(p, k) if p is not None else None
            for p, k in zip(points_affine, scalars)]
