"""SAVER verifiable encryption, host arm (keygen, batched encrypt and
rerandomize, verify_encryption).

A jax-free copy of the host functions of ``vote_saver_tpu/protocol/
saver.py`` (that module imports the JAX Groth16 module for its dataclasses),
typed on this package's Groth16 dataclasses.  Group work runs on the native
host kernels through ``refimpl.jacobian``; scheme spec: docs/SAVER_SPEC.md.
"""

from __future__ import annotations

import dataclasses

from vote_saver_tpu.params import R
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu.refimpl import pairing as rp

from .groth16 import Proof, VerificationKey


@dataclasses.dataclass
class SaverPublicKey:
    s_pts: list  # S_i = g^{s_i}, i = 1..n
    x_psi: tuple  # g^{t_0 + sum s_i t_i}
    y_pts: list  # Y_i = P_i^{t_i}

    @property
    def n(self):
        return len(self.s_pts)


@dataclasses.dataclass
class SaverSecretKey:
    s: list


@dataclasses.dataclass
class SaverVerificationKey:
    v_pts: list  # V_i = h^{s_i} in G2
    z_pts: list  # Z_0..Z_n in G2
    gamma_s: tuple  # gamma_h^{sum s_i} in G2


@dataclasses.dataclass
class Ciphertext:
    """(c_0, c_1..c_n, psi) — n+2 G1 points, componentwise addable."""

    points: list

    def __add__(self, other: "Ciphertext") -> "Ciphertext":
        assert len(self.points) == len(other.points), "Wrong size of the ct!"
        return Ciphertext([rc.g1_add(a, b) for a, b in zip(self.points, other.points)])


def message_bases(gvk: VerificationKey, n: int) -> list:
    """P_i = IC_i for the message wires (primary wires 1..n)."""
    return gvk.ic[1 : n + 1]


def keygen(gvk: VerificationKey, n: int, rnd: list[int]):
    """rnd: >= 2n+1 uniform Fr scalars (the protocol draws 3n+2)."""
    assert len(rnd) >= 2 * n + 1
    s = [x % R for x in rnd[:n]]
    t = [x % R for x in rnd[n : 2 * n + 1]]  # t_0..t_n
    p_bases = message_bases(gvk, n)
    x_psi_exp = (t[0] + sum(si * ti for si, ti in zip(s, t[1:]))) % R
    g1_pts = rj.FixedBaseHost(rc.g1_gen, "g1").mul_many(s + [x_psi_exp])
    y_pts = rj.g1_mul_many(p_bases, t[1:])
    g2_pts = rj.FixedBaseHost(rc.g2_gen, "g2").mul_many(s + t)
    gamma_s = rc.g2_mul(gvk.gamma_g2, sum(s) % R)
    return (
        SaverPublicKey(s_pts=g1_pts[:n], x_psi=g1_pts[n], y_pts=y_pts),
        SaverSecretKey(s=s),
        SaverVerificationKey(v_pts=g2_pts[:n], z_pts=g2_pts[n:], gamma_s=gamma_s),
    )


def encrypt_many(pk: SaverPublicKey, gvk: VerificationKey, ms: list[list[int]], rs: list[int]) -> list[Ciphertext]:
    """Batched encrypt over voters: one native pointwise-mul call for all
    B*(n+2) randomizer multiplications."""
    n = pk.n
    B = len(ms)
    assert len(rs) == B
    bases = [rc.g1_gen] + pk.s_pts + [pk.x_psi]
    all_scalars: list[int] = []
    for r in rs:
        all_scalars.extend([r] * (n + 2))
    randomized = rj.g1_mul_many(bases * B, all_scalars)
    p_bases = message_bases(gvk, n)
    outs = []
    for b in range(B):
        seg = randomized[b * (n + 2) : (b + 1) * (n + 2)]
        c0, cs, psi = seg[0], list(seg[1 : n + 1]), seg[n + 1]
        m = ms[b]
        for i in range(n):
            if m[i]:
                cs[i] = rc.g1_add(cs[i], rc.g1_mul(p_bases[i], m[i]))
                psi = rc.g1_add(psi, rc.g1_mul(pk.y_pts[i], m[i]))
        outs.append(Ciphertext([c0] + cs + [psi]))
    return outs


def rerandomize_many(pk: SaverPublicKey, delta_g2, cts: list[Ciphertext], proofs: list[Proof],
                     rnds: list[list[int]]) -> list[tuple[Ciphertext, Proof]]:
    """Re-blind each ciphertext with r' and its Groth16 proof with (z1, z2)."""
    B = len(cts)
    zs = []
    for rnd in rnds:
        z1, z2, r2 = (x % R for x in rnd[:3])
        if z1 == 0:
            z1 = 1
        zs.append((z1, z2, r2))
    n = pk.n
    bases = [rc.g1_gen] + pk.s_pts + [pk.x_psi]
    blind_scalars: list[int] = []
    for _, _, r2 in zs:
        blind_scalars.extend([r2] * (n + 2))
    blinds = rj.g1_mul_many(bases * B, blind_scalars)
    g1_res = rj.g1_mul_many(
        [p.a for p in proofs] + [p.a for p in proofs],
        [pow(z1, R - 2, R) for z1, _, _ in zs] + [z2 for _, z2, _ in zs],
    )
    g2_res = rj.g2_mul_many(
        [p.b for p in proofs] + [delta_g2] * B,
        [z1 for z1, _, _ in zs] + [z1 * z2 % R for z1, z2, _ in zs],
    )
    outs = []
    for b in range(B):
        seg = blinds[b * (n + 2) : (b + 1) * (n + 2)]
        new_pts = [rc.g1_add(p, s) for p, s in zip(cts[b].points, seg)]
        c = rc.g1_add(proofs[b].c, g1_res[B + b])
        bb = rc.g2_add(g2_res[b], g2_res[B + b])
        outs.append((Ciphertext(new_pts), Proof(a=g1_res[b], b=bb, c=c)))
    return outs


def verify_encryption(gvk: VerificationKey, svk: SaverVerificationKey, ct: Ciphertext,
                      proof: Proof, rest_primary: list[int]) -> bool:
    """(1) encrypted-Groth16 pairing check and (2) ciphertext
    well-formedness; rest_primary = the public wires after the message block."""
    n = len(ct.points) - 2
    c0, cs, psi = ct.points[0], ct.points[1:-1], ct.points[-1]
    d = gvk.ic[0]
    for a_i, pt in zip(rest_primary, gvk.ic[n + 1 :]):
        d = rc.g1_add(d, rc.g1_mul(pt, a_i))
    for ci in cs:
        d = rc.g1_add(d, ci)
    ok1 = rp.pairing_check(
        [
            (proof.a, proof.b),
            (c0, svk.gamma_s),
            (rc.g1_neg(gvk.alpha_g1), gvk.beta_g2),
            (rc.g1_neg(d), gvk.gamma_g2),
            (rc.g1_neg(proof.c), gvk.delta_g2),
        ]
    )
    if not ok1:
        return False
    pairs = [(rc.g1_neg(psi), rc.g2_gen), (c0, svk.z_pts[0])]
    pairs += [(ci, zi) for ci, zi in zip(cs, svk.z_pts[1:])]
    return rp.pairing_check(pairs)
