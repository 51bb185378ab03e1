"""Gadgets of the encrypted-input voting circuit.

Each gadget allocates variables/constraints at build time and knows how to
fill its variables in a *batched* witness (numpy object arrays over voters).
Semantics mirror the components the reference instantiates
(multipacking/merkle/pedersen/vote-validity, reference common.hpp:857-913)
but the constraint encodings are this repo's own (documented per gadget).
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import (
    R,
    JUBJUB_D,
    PEDERSEN_WINDOW_BITS,
    PEDERSEN_WINDOWS_PER_SEGMENT,
    PEDERSEN_SPACING_BITS,
    DIGEST_BITS,
    CHUNK_SIZE,
)
from .r1cs import ConstraintSystem, Witness, lc, lc_add, lc_scale, ONE

LC_ONE = {ONE: 1}
LC_ZERO: dict = {}


def batched_inv(a: np.ndarray) -> np.ndarray:
    flat = a.reshape(-1)
    out = np.empty(flat.shape[0], dtype=object)
    for i, x in enumerate(flat):
        out[i] = pow(int(x), R - 2, R)
    return out.reshape(a.shape)


def eval_lc(l: dict, w: np.ndarray):
    acc = np.zeros(w.shape[:-1], dtype=object)
    for v, c in l.items():
        acc = (acc + c * w[..., v]) % R
    return acc


def constrain_boolean(cs: ConstraintSystem, var: int):
    """var * (1 - var) = 0."""
    cs.constrain(lc((var, 1)), lc((ONE, 1), (var, -1)), LC_ZERO)


class OneHot:
    """m is a one-hot vector: every m_i boolean and sum m_i = 1.

    Mirrors the vote-validity (disjunction) part of encrypted_input_voting
    (reference common.hpp:46,158-160)."""

    def __init__(self, cs: ConstraintSystem, m_vars: list[int]):
        self.m_vars = m_vars
        for v in m_vars:
            constrain_boolean(cs, v)
        cs.constrain(lc(*[(v, 1) for v in m_vars]), LC_ONE, LC_ONE)

    def gen_witness(self, wit: Witness, vote_idx: np.ndarray):
        for j, v in enumerate(self.m_vars):
            wit.set(v, (np.asarray(vote_idx) == j).astype(object))


class Packing:
    """packed_k = sum of a 254-bit chunk of bits (little-endian).

    Mirrors multipacking_component (reference common.hpp:878-890) with
    chunk_size = 253+1 = CHUNK_SIZE; injective since 2^254 < R."""

    def __init__(self, cs: ConstraintSystem, bit_vars: list[int], packed_vars: list[int]):
        assert len(packed_vars) == (len(bit_vars) + CHUNK_SIZE - 1) // CHUNK_SIZE
        self.bit_vars, self.packed_vars = bit_vars, packed_vars
        for k, pv in enumerate(packed_vars):
            chunk = bit_vars[k * CHUNK_SIZE : (k + 1) * CHUNK_SIZE]
            cs.constrain(
                lc(*[(b, 1 << i) for i, b in enumerate(chunk)]), LC_ONE, lc((pv, 1))
            )

    def gen_witness_from_bits(self, wit: Witness):
        for k, pv in enumerate(self.packed_vars):
            chunk = self.bit_vars[k * CHUNK_SIZE : (k + 1) * CHUNK_SIZE]
            acc = np.zeros(wit.values.shape[0], dtype=object)
            for i, b in enumerate(chunk):
                acc = (acc + (wit.get(b) << i)) % R
            wit.set(pv, acc)


@functools.lru_cache(maxsize=None)
def _window_constants_cached(num_windows: int):
    """Per window: affine coords of (1+u) * 2^(4*local) * I_seg for u = 0..3."""
    from ..refimpl import pedersen as pd
    from ..refimpl import curves as rc

    consts = []
    for w in range(num_windows):
        seg, local = divmod(w, PEDERSEN_WINDOWS_PER_SEGMENT)
        base = rc.jj_mul(pd.segment_generator(seg), 1 << (PEDERSEN_SPACING_BITS * local))
        row = []
        p = base
        for _ in range(4):
            row.append(p)
            p = rc.jj_add(p, base)
        consts.append(row)
    return consts


def _window_constants(num_windows: int):
    """Cached window constants; rounded up to 64-window blocks so gadgets of
    different widths share one prefix computation."""
    n = (num_windows + 63) // 64 * 64
    return _window_constants_cached(n)[:num_windows]


class EdwardsAdd:
    """Complete twisted-Edwards addition (a=-1) of two LC points: 7 constraints.

    (x3, y3) with x3 (1 + d*E) = A + B and y3 (1 - d*E) = D + C where
    A = x1 y2, B = y1 x2, C = x1 x2, D = y1 y2, E = C*D."""

    def __init__(self, cs: ConstraintSystem, p1, p2):
        x1, y1 = p1
        x2, y2 = p2
        self.in1, self.in2 = p1, p2
        self.A, self.B, self.C, self.D, self.E = (cs.alloc() for _ in range(5))
        self.x3, self.y3 = cs.alloc(), cs.alloc()
        cs.constrain(x1, y2, lc((self.A, 1)))
        cs.constrain(y1, x2, lc((self.B, 1)))
        cs.constrain(x1, x2, lc((self.C, 1)))
        cs.constrain(y1, y2, lc((self.D, 1)))
        cs.constrain(lc((self.C, 1)), lc((self.D, 1)), lc((self.E, 1)))
        cs.constrain(
            lc((self.x3, 1)), lc((ONE, 1), (self.E, JUBJUB_D)), lc((self.A, 1), (self.B, 1))
        )
        cs.constrain(
            lc((self.y3, 1)), lc((ONE, 1), (self.E, -JUBJUB_D)), lc((self.C, 1), (self.D, 1))
        )
        self.out = (lc((self.x3, 1)), lc((self.y3, 1)))

    def gen_witness(self, wit: Witness):
        w = wit.values
        x1, y1 = eval_lc(self.in1[0], w), eval_lc(self.in1[1], w)
        x2, y2 = eval_lc(self.in2[0], w), eval_lc(self.in2[1], w)
        a = x1 * y2 % R
        b = y1 * x2 % R
        c = x1 * x2 % R
        d = y1 * y2 % R
        e = c * d % R
        wit.set(self.A, a)
        wit.set(self.B, b)
        wit.set(self.C, c)
        wit.set(self.D, d)
        wit.set(self.E, e)
        wit.set(self.x3, (a + b) % R * batched_inv((1 + JUBJUB_D * e) % R) % R)
        wit.set(self.y3, (c + d) % R * batched_inv((1 - JUBJUB_D * e) % R) % R)


class PedersenGadget:
    """Windowed Pedersen hash over LC bits; output = point (x, y) LC pair.

    Per 3-bit window (s0, s1, s2): one constraint for t = s0*s1, one for the
    sign flip, and a complete Edwards add (7) into the accumulator.  Matches
    the out-of-circuit kernel in ops/pedersen_ops.py bit-for-bit (enforced by
    tests), which is the acceptance criterion SURVEY.md §7 sets for the
    in-circuit Pedersen."""

    def __init__(self, cs: ConstraintSystem, bit_lcs: list[dict]):
        bits = list(bit_lcs)
        while len(bits) % PEDERSEN_WINDOW_BITS:
            bits.append(LC_ZERO)
        num_windows = len(bits) // PEDERSEN_WINDOW_BITS
        self.consts = _window_constants(num_windows)
        self.windows = []
        acc = None
        self.adds: list[EdwardsAdd] = []
        for w in range(num_windows):
            s0, s1, s2 = bits[3 * w], bits[3 * w + 1], bits[3 * w + 2]
            (x1c, y1c), (x2c, y2c), (x3c, y3c), (x4c, y4c) = self.consts[w]
            # multilinear interpolation over (s0, s1):
            #   u=0 -> P1, u=1 -> P2, u=2 -> P3, u=3 -> P4
            t = cs.alloc()
            cs.constrain(s0, s1, lc((t, 1)))
            xs = [x1c, x2c, x3c, x4c]
            ys = [y1c, y2c, y3c, y4c]
            x_sel = lc_add(
                lc_add(lc_scale(LC_ONE, xs[0]), lc_scale(s0, xs[1] - xs[0])),
                lc_add(lc_scale(s1, xs[2] - xs[0]), lc_scale({t: 1}, xs[3] - xs[2] - xs[1] + xs[0])),
            )
            y_sel = lc_add(
                lc_add(lc_scale(LC_ONE, ys[0]), lc_scale(s0, ys[1] - ys[0])),
                lc_add(lc_scale(s1, ys[2] - ys[0]), lc_scale({t: 1}, ys[3] - ys[2] - ys[1] + ys[0])),
            )
            # conditional negation of x by s2 (digit sign)
            xw = cs.alloc()
            cs.constrain(x_sel, lc_add(LC_ONE, lc_scale(s2, -2)), lc((xw, 1)))
            point = (lc((xw, 1)), y_sel)
            self.windows.append((s0, s1, s2, t, xw, x_sel))
            if acc is None:
                acc = point
            else:
                addg = EdwardsAdd(cs, acc, point)
                self.adds.append(addg)
                acc = addg.out
        self.out = acc  # (x_lc, y_lc)

    def gen_witness(self, wit: Witness):
        w = wit.values
        for s0, s1, s2, t, xw, x_sel in self.windows:
            s0v, s1v, s2v = eval_lc(s0, w), eval_lc(s1, w), eval_lc(s2, w)
            wit.set(t, s0v * s1v % R)
            xs = eval_lc(x_sel, wit.values)
            wit.set(xw, xs * (1 - 2 * s2v) % R)
        for addg in self.adds:
            addg.gen_witness(wit)


class DigestDecompose:
    """x (LC) -> 255 boolean little-endian bit vars with sum b_i 2^i = x.

    With canonical=True additionally enforces value <= R-1 so the
    decomposition is unique (required for the serial number — otherwise a
    voter could derive two sns from one (eid, sk) and double-vote; see the
    double-vote rejection this feeds on-chain, reference
    voting_admin.sol:120-124)."""

    def __init__(self, cs: ConstraintSystem, x_lc: dict, canonical: bool = False):
        self.x_lc = x_lc
        self.bits = cs.alloc_vec(DIGEST_BITS)
        for b in self.bits:
            constrain_boolean(cs, b)
        cs.constrain(lc(*[(b, 1 << i) for i, b in enumerate(self.bits)]), LC_ONE, x_lc)
        self.canonical = canonical
        self.lt_steps = []
        if canonical:
            c = R - 1
            lt = LC_ZERO
            for i in range(DIGEST_BITS - 1, -1, -1):
                b = self.bits[i]
                if (c >> i) & 1:
                    t = cs.alloc()
                    cs.constrain(lc_add(LC_ONE, lc_scale(lt, -1)), lc((b, 1)), lc((t, 1)))
                    self.lt_steps.append((i, t, lt))
                    lt = lc((ONE, 1), (t, -1))
                else:
                    cs.constrain(lc((b, 1)), lc_add(LC_ONE, lc_scale(lt, -1)), LC_ZERO)

    def gen_witness(self, wit: Witness):
        x = eval_lc(self.x_lc, wit.values)
        for i, b in enumerate(self.bits):
            wit.set(b, (x >> i) & 1)
        for i, t, lt in self.lt_steps:
            ltv = eval_lc(lt, wit.values)
            bv = wit.get(b := self.bits[i])
            wit.set(t, (1 - ltv) % R * bv % R)


class MerkleLevel:
    """One tree level: select (left, right) hash inputs by the address bit,
    then Pedersen-hash and decompose the parent digest.

    left_i = cur_i + addr*(sib_i - cur_i)  (one constraint per bit);
    right_i = cur_i + sib_i - left_i       (linear, free).
    Mirrors merkle_proof_component semantics (reference common.hpp:897-898)."""

    def __init__(self, cs: ConstraintSystem, cur_bits: list[dict], sib_vars: list[int], addr_var: int):
        self.cur_bits, self.sib_vars, self.addr = cur_bits, sib_vars, addr_var
        self.left = cs.alloc_vec(DIGEST_BITS)
        left_lcs, right_lcs = [], []
        for i in range(DIGEST_BITS):
            cur, sib = cur_bits[i], lc((sib_vars[i], 1))
            delta = lc_add(sib, lc_scale(cur, -1))
            cs.constrain(lc((addr_var, 1)), delta, lc_add({self.left[i]: 1}, lc_scale(cur, -1)))
            left_lcs.append(lc((self.left[i], 1)))
            right_lcs.append(lc_add(lc_add(cur, sib), {self.left[i]: -1}))
        self.hash = PedersenGadget(cs, left_lcs + right_lcs)
        self.decompose = DigestDecompose(cs, self.hash.out[0])
        self.out_bits = [lc((b, 1)) for b in self.decompose.bits]

    def gen_witness(self, wit: Witness):
        w = wit.values
        addr = eval_lc(lc((self.addr, 1)), w)
        for i in range(DIGEST_BITS):
            cur = eval_lc(self.cur_bits[i], w)
            sib = wit.get(self.sib_vars[i])
            wit.set(self.left[i], (cur + addr * (sib - cur)) % R)
        self.hash.gen_witness(wit)
        self.decompose.gen_witness(wit)
