"""Big-integer tower-field arithmetic for BLS12-381: Fq, Fq2, Fq6, Fq12, Fr.

Tower (standard BLS12-381 construction):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - (u + 1))
    Fq12 = Fq6[w] / (w^2 - v)

Elements are plain ints (Fq, Fr) or nested tuples (Fq2 = (c0, c1), etc.).
Used as the test oracle and for host-side pairings (verification paths only);
the device kernels in :mod:`vote_saver_tpu.ops` carry the hot paths.
"""

from __future__ import annotations

from ..params import Q, R, FR_GENERATOR, FR_TWO_ADICITY

# ---------------------------------------------------------------------------
# Fq / Fr (plain ints)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, Q - 2, Q)


def fr_inv(a: int) -> int:
    return pow(a, R - 2, R)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (q = 3 mod 4); None if a is a non-residue."""
    a %= Q
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a else None


def fr_sqrt(a: int) -> int | None:
    """Square root in Fr via Tonelli–Shanks (r - 1 = 2^32 * t)."""
    a %= R
    if a == 0:
        return 0
    if pow(a, (R - 1) // 2, R) != 1:
        return None
    t = (R - 1) >> FR_TWO_ADICITY
    z = pow(FR_GENERATOR, t, R)  # generator of the 2-Sylow subgroup
    m = FR_TWO_ADICITY
    c = z
    u = pow(a, t, R)
    x = pow(a, (t + 1) // 2, R)
    while u != 1:
        # find least i with u^(2^i) == 1
        i, s = 0, u
        while s != 1:
            s = s * s % R
            i += 1
        b = pow(c, 1 << (m - i - 1), R)
        m, c = i, b * b % R
        u = u * c % R
        x = x * b % R
    return x


# ---------------------------------------------------------------------------
# Fq2 = (c0, c1), u^2 = -1
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (1, 1)  # v^3 = u + 1


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_mul(a, b):
    # Karatsuba: 3 base mults.
    t0 = a[0] * b[0] % Q
    t1 = a[1] * b[1] % Q
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % Q
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_sq(a):
    # (c0+c1 u)^2 = (c0+c1)(c0-c1) + 2 c0 c1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1]) % Q
    t1 = 2 * a[0] * a[1] % Q
    return (t0, t1)


def fq2_muls(a, s: int):
    return (a[0] * s % Q, a[1] * s % Q)


def fq2_inv(a):
    norm_inv = fq_inv((a[0] * a[0] + a[1] * a[1]) % Q)
    return (a[0] * norm_inv % Q, (-a[1] * norm_inv) % Q)


def fq2_pow(a, e: int):
    res, base = FQ2_ONE, a
    while e:
        if e & 1:
            res = fq2_mul(res, base)
        base = fq2_sq(base)
        e >>= 1
    return res


def fq2_sqrt(a):
    """Square root in Fq2 for q = 3 mod 4 (Adj–Rodriguez); None if QNR."""
    if a == FQ2_ZERO:
        return FQ2_ZERO
    a1 = fq2_pow(a, (Q - 3) // 4)
    alpha = fq2_mul(fq2_sq(a1), a)
    x0 = fq2_mul(a1, a)
    if alpha == (Q - 1, 0):  # alpha == -1
        res = (Q - x0[1] if x0[1] else 0, x0[0])  # u * x0
    else:
        b = fq2_pow(fq2_add(FQ2_ONE, alpha), (Q - 1) // 2)
        res = fq2_mul(b, x0)
    return res if fq2_sq(res) == a else None


# ---------------------------------------------------------------------------
# Fq6 = (a0, a1, a2) over Fq2, v^3 = XI = u + 1
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _mul_xi(a):
    # (c0 + c1 u) * (1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % Q, (a[0] + a[1]) % Q)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    # Toom-style with reduction by v^3 = XI.
    t0 = fq2_mul(a[0], b[0])
    t1 = fq2_mul(a[1], b[1])
    t2 = fq2_mul(a[2], b[2])
    c0 = fq2_add(t0, _mul_xi(fq2_sub(fq2_mul(fq2_add(a[1], a[2]), fq2_add(b[1], b[2])), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a[0], a[1]), fq2_add(b[0], b[1])), fq2_add(t0, t1)), _mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a[0], a[2]), fq2_add(b[0], b[2])), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = a2*XI + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    c0 = fq2_sub(fq2_sq(a[0]), _mul_xi(fq2_mul(a[1], a[2])))
    c1 = fq2_sub(_mul_xi(fq2_sq(a[2])), fq2_mul(a[0], a[1]))
    c2 = fq2_sub(fq2_sq(a[1]), fq2_mul(a[0], a[2]))
    t = fq2_add(fq2_mul(a[0], c0), _mul_xi(fq2_add(fq2_mul(a[2], c1), fq2_mul(a[1], c2))))
    t_inv = fq2_inv(t)
    return (fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


# ---------------------------------------------------------------------------
# Fq12 = (b0, b1) over Fq6, w^2 = v
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c1 = fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), fq6_add(t0, t1))
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    t = fq6_inv(fq6_sub(fq6_sq(a[0]), fq6_mul_by_v(fq6_sq(a[1]))))
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_conj(a):
    """Conjugation = q^6-power Frobenius (inverse on the cyclotomic subgroup)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        a, e = fq12_inv(a), -e
    res, base = FQ12_ONE, a
    while e:
        if e & 1:
            res = fq12_mul(res, base)
        base = fq12_sq(base)
        e >>= 1
    return res


# Frobenius: gamma = XI^((q-1)/6); powers precomputed once at import.
_FROB_GAMMA = [fq2_pow(XI, i * (Q - 1) // 6) for i in range(6)]


def fq2_frob(a):
    return fq2_conj(a)


def fq6_frob(a):
    return (
        fq2_conj(a[0]),
        fq2_mul(fq2_conj(a[1]), _FROB_GAMMA[2]),
        fq2_mul(fq2_conj(a[2]), _FROB_GAMMA[4]),
    )


def fq12_frob(a):
    """a ↦ a^q.  w^q = XI^((q-1)/6) * w, so the b1 coefficient picks up a
    uniform Fq2 factor gamma^1 on top of the Fq6 Frobenius."""
    b0 = fq6_frob(a[0])
    t = fq6_frob(a[1])
    g = _FROB_GAMMA[1]
    return (b0, (fq2_mul(t[0], g), fq2_mul(t[1], g), fq2_mul(t[2], g)))


def fq12_frob_n(a, n: int):
    for _ in range(n % 12):
        a = fq12_frob(a)
    return a
