"""Parse key, proof and ciphertext blobs into this package's dataclasses.

The JAX package's deserializers import its jax-bound Groth16/SAVER modules
for their dataclasses; the byte-level helpers they use (``de_g1``,
``de_g2``, ``_de_g1_vec``, ``_de_g2_vec``, ``de_scalar_vector``) are
jax-free and reused here.  The ``ser_*`` writers are duck-typed and work on
these dataclasses as they are.  Wire formats: docs/WIRE_FORMATS.md.
"""

from __future__ import annotations

import struct

from vote_saver_tpu.protocol import marshal as M

from .groth16 import Proof, ProvingKey, VerificationKey
from .saver import Ciphertext, SaverPublicKey, SaverSecretKey, SaverVerificationKey

G1, G2 = M.G1_SIZE, M.G2_SIZE


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"bad {what} blob")


def de_proof(blob: bytes) -> Proof:
    _expect(len(blob) == 2 * G1 + G2, "proof")
    return Proof(a=M.de_g1(blob[:G1]), b=M.de_g2(blob[G1 : G1 + G2]), c=M.de_g1(blob[G1 + G2 :]))


def de_groth16_vk(blob: bytes) -> VerificationKey:
    off = 0
    alpha = M.de_g1(blob[:G1])
    off += G1
    beta, gamma, delta = (M.de_g2(blob[off + k * G2 : off + (k + 1) * G2]) for k in range(3))
    off += 3 * G2
    ic, off = M._de_g1_vec(blob, off)
    _expect(off == len(blob), "vk")
    return VerificationKey(alpha_g1=alpha, beta_g2=beta, gamma_g2=gamma, delta_g2=delta, ic=ic)


def de_groth16_pk(blob: bytes, coo: dict) -> ProvingKey:
    """The constraint matrices are not in the blob: the caller passes the
    COO of the circuit rebuilt for this tree depth."""
    ni, nv, dom, nc = struct.unpack(">QQQQ", blob[:32])
    off = 32
    a, off = M._de_g1_vec(blob, off)
    b1, off = M._de_g1_vec(blob, off)
    b2, off = M._de_g2_vec(blob, off)
    h, off = M._de_g1_vec(blob, off)
    l, off = M._de_g1_vec(blob, off)
    singles = []
    for size, de in ((G1, M.de_g1), (G1, M.de_g1), (G2, M.de_g2), (G1, M.de_g1), (G2, M.de_g2)):
        singles.append(de(blob[off : off + size]))
        off += size
    _expect(off == len(blob), "pk")
    alpha, beta1, beta2, delta1, delta2 = singles
    return ProvingKey(
        num_primary=ni, num_vars=nv, domain=dom,
        a_pts=a, b1_pts=b1, b2_pts=b2, h_pts=h, l_pts=l,
        alpha_g1=alpha, beta_g1=beta1, beta_g2=beta2, delta_g1=delta1, delta_g2=delta2,
        coo=coo, num_constraints=nc,
    )


def de_saver_pk(blob: bytes) -> SaverPublicKey:
    s, off = M._de_g1_vec(blob, 0)
    x_psi = M.de_g1(blob[off : off + G1])
    off += G1
    y, off = M._de_g1_vec(blob, off)
    _expect(off == len(blob), "saver pk")
    return SaverPublicKey(s_pts=s, x_psi=x_psi, y_pts=y)


def de_saver_sk(blob: bytes) -> SaverSecretKey:
    return SaverSecretKey(s=M.de_scalar_vector(blob))


def de_saver_vk(blob: bytes) -> SaverVerificationKey:
    v, off = M._de_g2_vec(blob, 0)
    z, off = M._de_g2_vec(blob, off)
    gamma_s = M.de_g2(blob[off : off + G2])
    _expect(off + G2 == len(blob), "saver vk")
    return SaverVerificationKey(v_pts=v, z_pts=z, gamma_s=gamma_s)


def de_ct(blob: bytes) -> Ciphertext:
    pts, off = M._de_g1_vec(blob, 0)
    _expect(off == len(blob), "ct")
    return Ciphertext(points=pts)
