"""Inputs that drive every special lane of the curve kernels K2-K4.

Shared by the CPU tests and chip_smoke.py, so the kernels meet the same
corner cases on the card as their plain versions meet against the Pallas
formulas on the CPU.  Host ints only; callers move them to tensors.
"""

from __future__ import annotations

import contextlib
import random

import torch

from vote_saver_tpu.params import Q
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import field as rf
from vote_saver_tpu.refimpl import jacobian as rj


@contextlib.contextmanager
def torch_threads(n: int):
    """Run with n intra-op CPU threads, restoring the count after.  The
    test rig runs several pytest workers on one host, and the plain
    versions' many small ops slow down several-fold when every worker's
    torch also spawns a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# madd lanes 0-7: acc infinite lifts q (+, -), (0, 0) q, inactive, doubling
# corner, opposite by sign, opposite by acc = -q, generic
MADD_SIGN = [False, True, False, False, False, True, False, True]
MADD_ACTIVE = [True, True, True, False, True, True, True, True]
MADD_EXC = [0, 0, 0, 0, 1, 0, 0, 0]


def neg_y(y, g2: bool):
    return rf.fq2_neg(y) if g2 else (Q - y) % Q


def jacobian(p, z, g2: bool):
    """Affine point -> Jacobian ints (x z^2, y z^3, z)."""
    if g2:
        z2 = rf.fq2_sq(z)
        return (rf.fq2_mul(p[0], z2), rf.fq2_mul(p[1], rf.fq2_mul(z2, z)), z)
    return (p[0] * z * z % Q, p[1] * z * z % Q * z % Q, z)


def special_lanes(g2: bool, n: int, rnd: random.Random):
    """(p, q, acc, q_affine, sign, active) for n >= 8 lanes.

    Complete add p + q, lanes 0-5: inf + q, p + inf, inf + inf, p + p with
    the same limbs, p + p with another Z, p + (-p).  Mixed add acc += q
    (affine, signed, maybe inactive): lanes 0-7 as MADD_SIGN / MADD_ACTIVE,
    with the exc flag expected as MADD_EXC.  The other lanes are random
    points with random Z (and random sign / 90% active for the madd)."""
    gen, group = (rc.g2_gen, "g2") if g2 else (rc.g1_gen, "g1")
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    inf = (one, one, zero)

    def rz():
        return (rnd.randrange(1, Q), rnd.randrange(Q)) if g2 else rnd.randrange(1, Q)

    aff = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, 1 << 255) for _ in range(2 * n)])
    pa, qa = aff[:n], aff[n:]
    p = [jacobian(a, rz(), g2) for a in pa]
    q = [jacobian(a, rz(), g2) for a in qa]
    p[0], q[1], p[2], q[2] = inf, inf, inf, inf
    q[3] = p[3]
    q[4] = jacobian(pa[4], rz(), g2)
    q[5] = jacobian((pa[5][0], neg_y(pa[5][1], g2)), rz(), g2)
    acc, qm = list(p), list(qa)
    sign = MADD_SIGN + [rnd.random() < 0.5 for _ in range(n - 8)]
    active = MADD_ACTIVE + [rnd.random() < 0.9 for _ in range(n - 8)]
    acc[1] = inf
    qm[2] = (zero, zero)
    acc[4] = jacobian(qm[4], rz(), g2)
    acc[5] = jacobian(qm[5], rz(), g2)
    acc[6] = jacobian((qm[6][0], neg_y(qm[6][1], g2)), rz(), g2)
    return p, q, acc, qm, sign, active
