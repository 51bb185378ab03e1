"""Reference (Python-int) elliptic curve arithmetic: BLS12-381 G1/G2, JubJub.

G1/G2 points are affine tuples ``(x, y)`` with ``None`` for the point at
infinity; coordinates are ints (G1) or Fq2 tuples (G2).  JubJub points are
affine twisted-Edwards tuples ``(x, y)`` (identity = (0, 1), always defined).

Replaces the reference's crypto3::algebra usage (see SURVEY.md §2B `algebra`
row; usage at reference common.hpp:34-42,107-129,1214,1277); implemented from
the curve standards, not translated.
"""

from __future__ import annotations

from ..params import (
    Q,
    R,
    B_G1,
    G1_GEN,
    G2_GEN,
    JUBJUB_A,
    JUBJUB_D,
    JUBJUB_RS,
    JUBJUB_COFACTOR,
)
from . import field as f

# ---------------------------------------------------------------------------
# Generic short-Weierstrass affine arithmetic parameterised by a field.
# ---------------------------------------------------------------------------


class _WeierstrassOps:
    """y^2 = x^3 + b over an abstract field given by (add, sub, mul, inv, neg)."""

    def __init__(self, add, sub, mul, inv, neg, zero, one, b):
        self.fadd, self.fsub, self.fmul, self.finv, self.fneg = add, sub, mul, inv, neg
        self.zero, self.one, self.b = zero, one, b

    def is_on_curve(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return lhs == rhs

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.fneg(p[1]))

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if y1 != y2 or y1 == self.zero:
                return None
            # doubling: λ = 3x^2 / 2y  (a = 0)
            num = self.fmul(self.fmul(x1, x1), self.fadd(self.fadd(self.one, self.one), self.one))
            den = self.fadd(y1, y1)
        else:
            num = self.fsub(y2, y1)
            den = self.fsub(x2, x1)
        lam = self.fmul(num, self.finv(den))
        x3 = self.fsub(self.fsub(self.fmul(lam, lam), x1), x2)
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, p, k: int):
        k %= R  # scalars live in Fr for both G1 and G2
        acc = None
        base = p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.add(base, base)
            k >>= 1
        return acc


_fq_ops = _WeierstrassOps(
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    mul=lambda a, b: a * b % Q,
    inv=f.fq_inv,
    neg=lambda a: (-a) % Q,
    zero=0,
    one=1,
    b=B_G1,
)

_fq2_ops = _WeierstrassOps(
    add=f.fq2_add,
    sub=f.fq2_sub,
    mul=f.fq2_mul,
    inv=f.fq2_inv,
    neg=f.fq2_neg,
    zero=f.FQ2_ZERO,
    one=f.FQ2_ONE,
    b=(f.XI[0] * B_G1 % Q, f.XI[1] * B_G1 % Q),  # 4(u+1), M-twist
)

# --- G1 ---------------------------------------------------------------------

g1_add = _fq_ops.add
g1_neg = _fq_ops.neg
g1_mul = _fq_ops.mul
g1_is_on_curve = _fq_ops.is_on_curve
g1_gen = G1_GEN


def g1_multiexp(points, scalars):
    """Naive reference MSM: sum_i scalars[i] * points[i]."""
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# --- G2 ---------------------------------------------------------------------

g2_add = _fq2_ops.add
g2_neg = _fq2_ops.neg
g2_mul = _fq2_ops.mul
g2_is_on_curve = _fq2_ops.is_on_curve
g2_gen = G2_GEN


def g2_multiexp(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        acc = g2_add(acc, g2_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# JubJub: twisted Edwards over Fr,  a x^2 + y^2 = 1 + d x^2 y^2, a = -1.
# Complete addition law — no special cases.
# ---------------------------------------------------------------------------

JJ_IDENTITY = (0, 1)


def jj_is_on_curve(p) -> bool:
    x, y = p
    lhs = (JUBJUB_A * x * x + y * y) % R
    rhs = (1 + JUBJUB_D * x * x % R * y % R * y) % R
    return lhs == rhs


def jj_add(p, q):
    x1, y1 = p
    x2, y2 = q
    t = JUBJUB_D * x1 % R * x2 % R * y1 % R * y2 % R
    x3 = (x1 * y2 + y1 * x2) % R * pow(1 + t, R - 2, R) % R
    y3 = (y1 * y2 - JUBJUB_A * x1 % R * x2) % R * pow(1 - t, R - 2, R) % R
    return (x3, y3)


def jj_neg(p):
    return ((-p[0]) % R, p[1])


def _jj_add_proj(p, q):
    """Unified projective twisted-Edwards add (complete for a=-1, d
    non-square) — inversion-free, so scalar ladders don't pay two modular
    inverses per step the way the affine `jj_add` does."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    a = z1 * z2 % R
    b = a * a % R
    c = x1 * x2 % R
    d = y1 * y2 % R
    e = JUBJUB_D * c % R * d % R
    f = (b - e) % R
    g = (b + e) % R
    x3 = a * f % R * (((x1 + y1) * (x2 + y2) - c - d) % R) % R
    y3 = a * g % R * ((d - JUBJUB_A * c) % R) % R
    z3 = f * g % R
    return (x3, y3, z3)


def jj_mul(p, k: int):
    k %= JUBJUB_RS * JUBJUB_COFACTOR
    acc, base = (0, 1, 1), (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = _jj_add_proj(acc, base)
        base = _jj_add_proj(base, base)
        k >>= 1
    zi = pow(acc[2], R - 2, R)
    return (acc[0] * zi % R, acc[1] * zi % R)
