"""BLS12-381 optimal ate pairing (reference implementation, Python ints).

Strategy: correctness over speed.  G2 points are *untwisted* into E(Fq12) and
the Miller loop runs with generic affine line evaluations in full Fq12
arithmetic — no sparse-multiplication tricks to get subtly wrong.  Pairings
only appear on verification paths (Groth16 verify, SAVER verify_encryption /
verify_decryption — reference common.hpp:1164-1168,1282-1284), never in the
per-ballot proving hot path, so tens of milliseconds per pairing is fine.

``pairing_product`` shares a single final exponentiation across many pairs,
which is what the n+1-term SAVER ciphertext-validity check uses.
"""

from __future__ import annotations

from ..params import Q, R, BLS_X
from . import field as f

# --- embeddings -------------------------------------------------------------


def _fq2_to_fq12(c):
    return ((c, f.FQ2_ZERO, f.FQ2_ZERO), f.FQ6_ZERO)


def _fq_to_fq12(c: int):
    return _fq2_to_fq12((c % Q, 0))


_W = (f.FQ6_ZERO, f.FQ6_ONE)  # the tower generator w
_W2_INV = f.fq12_inv(f.fq12_mul(_W, _W))
_W3_INV = f.fq12_inv(f.fq12_mul(f.fq12_mul(_W, _W), _W))


def untwist(q2):
    """Map a point on the M-twist E'(Fq2) to E(Fq12): (x,y) -> (x/w^2, y/w^3)."""
    if q2 is None:
        return None
    x = f.fq12_mul(_fq2_to_fq12(q2[0]), _W2_INV)
    y = f.fq12_mul(_fq2_to_fq12(q2[1]), _W3_INV)
    return (x, y)


# --- E(Fq12) affine arithmetic ----------------------------------------------


def _e12_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2:
            return None
        num = f.fq12_mul(_fq_to_fq12(3), f.fq12_mul(x1, x1))
        den = f.fq12_add(y1, y1)
    else:
        num = f.fq12_sub(y2, y1)
        den = f.fq12_sub(x2, x1)
    lam = f.fq12_mul(num, f.fq12_inv(den))
    x3 = f.fq12_sub(f.fq12_sub(f.fq12_mul(lam, lam), x1), x2)
    y3 = f.fq12_sub(f.fq12_mul(lam, f.fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(a, b, p):
    """Evaluate at p the line through a and b (or tangent if a == b)."""
    xa, ya = a
    xb, yb = b
    xp, yp = p
    if xa == xb and ya != yb:
        # vertical line
        return f.fq12_sub(xp, xa)
    if a == b:
        num = f.fq12_mul(_fq_to_fq12(3), f.fq12_mul(xa, xa))
        den = f.fq12_add(ya, ya)
    else:
        num = f.fq12_sub(yb, ya)
        den = f.fq12_sub(xb, xa)
    lam = f.fq12_mul(num, f.fq12_inv(den))
    return f.fq12_sub(f.fq12_sub(yp, ya), f.fq12_mul(lam, f.fq12_sub(xp, xa)))


# --- Miller loop ------------------------------------------------------------

_ATE_BITS = bin(abs(BLS_X))[3:]  # bits below the MSB


def miller_loop(p1, q2) -> tuple:
    """f_{|x|,Q}(P) with Q untwisted into E(Fq12); conjugated because x < 0."""
    if p1 is None or q2 is None:
        return f.FQ12_ONE
    p = (_fq_to_fq12(p1[0]), _fq_to_fq12(p1[1]))
    q = untwist(q2)
    t = q
    acc = f.FQ12_ONE
    for bit in _ATE_BITS:
        acc = f.fq12_mul(f.fq12_sq(acc), _line(t, t, p))
        t = _e12_add(t, t)
        if bit == "1":
            acc = f.fq12_mul(acc, _line(t, q, p))
            t = _e12_add(t, q)
    # BLS parameter x is negative: f_{-n} ~ conj(f_n) up to factors killed by
    # the final exponentiation.
    return f.fq12_conj(acc)


_HARD_EXP = (Q**4 - Q**2 + 1) // R


def final_exponentiation(a) -> tuple:
    # easy part: a^((q^6 - 1)(q^2 + 1))
    a = f.fq12_mul(f.fq12_conj(a), f.fq12_inv(a))
    a = f.fq12_mul(f.fq12_frob_n(a, 2), a)
    # hard part: a^((q^4 - q^2 + 1)/r)
    return f.fq12_pow(a, _HARD_EXP)


def pairing(p1, q2) -> tuple:
    """e(P, Q) for P in G1(Fq), Q in G2(Fq2).  Returns an Fq12 element."""
    return final_exponentiation(miller_loop(p1, q2))


def pairing_product(pairs) -> tuple:
    """prod_i e(P_i, Q_i) with one shared final exponentiation."""
    acc = f.FQ12_ONE
    for p1, q2 in pairs:
        acc = f.fq12_mul(acc, miller_loop(p1, q2))
    return final_exponentiation(acc)


def pairing_check(pairs) -> bool:
    """True iff prod_i e(P_i, Q_i) == 1.

    Dispatches to the native C++ pairing (same generic algorithm, ~1000x)
    when built; this Python path is its correctness oracle."""
    from .. import native_bridge as nb

    if nb.available():
        return nb.pairing_check(list(pairs))
    return pairing_product(pairs) == f.FQ12_ONE
