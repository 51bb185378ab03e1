"""Device ballot tail: Groth16 blinding + SAVER encryption + rerandomization
as batched curve kernels.

Counterpart of ``vote_saver_tpu/protocol/ballot_dev.py``.  The prover's
five MSM outputs stay on the device and one batched pass finishes the
ballots (complete adds K3, doublings K4, 4-bit windowed scalar multiplies):

  * ct = u * [g | S_1..S_n | x_psi] + E(vote), with u = r + r' (encryption
    with randomizer r, at once rerandomized by r', depends only on u);
  * A' = z1^-1 * (alpha + A + r*delta1);
  * B' = z1 * (beta2 + B2) + z1*(s + z2) * delta2;
  * C' = L + H + (s + z2)*(alpha + A + r*delta1) + r*(beta1 + B1 + s*delta1)
         - (r*s)*delta1,

which is algebraically the host blinding followed by the host rerandomize.
Randomness is drawn in exactly the host path's order (blinding (r, s) pairs,
then the encryption r, then three rerandomization scalars per ballot), so a
seeded FrRandom gives byte-identical ballots on either path.  The JAX
module's arm policy, telemetry, sticky host arm and retry ladder have no
counterpart here: a failing kernel fails the run.  ``_finalize_host`` (the
same algebra on native host multiplies) is the tests' oracle.
"""

from __future__ import annotations

import torch

from ..params import R
from ..refimpl import curves as rc
from ..refimpl import jacobian as rj
from ..utils.rng import FrRandom
from ..ops import curve_ops as co
from ..ops import limbs as lb
from ..ops import msm as msm_mod
from .groth16 import Proof, ProvingKey, VerificationKey
from .saver import Ciphertext, SaverPublicKey, message_bases


def _bcast(coords, B: int):
    """(1, ...) coords -> (B, ...) broadcast views."""
    return tuple(c.expand((B,) + tuple(c.shape[1:])) for c in coords)


def _finalize(B: int, n: int, const: dict, outs: dict, digits1, digits2, digits_g2, e_pts):
    """The batched device pass; returns Jacobian (A', B', C', ct)."""
    g1, g2 = co.g1_ops(), co.g2_ops()
    blk = n + 5  # per-ballot round-1 lanes: 3 delta1 blinds + n + 2 ct bases

    # round 1 (independent of the MSM outputs): delta1 * {r, s, rs} and the
    # merged encrypt + rerandomize fixed-base pass u * bases
    pts1 = tuple(c.repeat((B,) + (1,) * (c.dim() - 1)) for c in const["g1_fixed"])
    r1 = tuple(c.reshape((B, blk) + tuple(c.shape[1:])) for c in g1.scalar_mul_windowed(pts1, digits1))
    d1r, d1s, d1rs = (tuple(c[:, k] for c in r1) for k in range(3))
    ct0 = tuple(c[:, 3:] for c in r1)

    # blinded A / B1, then the dependent variable-base round
    a_bl = g1.add(g1.add(_bcast(const["alpha"], B), outs["a"]), d1r)
    b1_bl = g1.add(g1.add(_bcast(const["beta1"], B), outs["b1"]), d1s)
    r2 = g1.scalar_mul_windowed(tuple(torch.cat([ca, cb, ca]) for ca, cb in zip(a_bl, b1_bl)), digits2)
    sza = tuple(c[:B] for c in r2)  # (s + z2) * A_blinded
    rb1 = tuple(c[B : 2 * B] for c in r2)  # r * B1_blinded
    a_fin = tuple(c[2 * B :] for c in r2)  # z1^-1 * A_blinded

    # G2: z1 * (beta2 + B2) and delta2 * (z1 (s + z2)), then their sum
    b2s = g2.add(_bcast(const["beta2"], B), outs["b2"])
    rg2 = g2.scalar_mul_windowed(tuple(torch.cat([c, d]) for c, d in zip(b2s, _bcast(const["delta2"], B))),
                                 digits_g2)
    b_fin = g2.add(tuple(c[:B] for c in rg2), tuple(c[B:] for c in rg2))

    # C' = L + H + sza + rb1 - rs * delta1
    c_fin = g1.add(g1.add(g1.add(outs["l"], outs["h"]), sza), g1.add(rb1, g1.neg(d1rs)))

    # the ciphertext's message term: one complete add against the sparse E
    ct = g1.add(ct0, e_pts)
    return a_fin, b_fin, c_fin, ct


def _const(pk: ProvingKey, spk: SaverPublicKey, gvk: VerificationKey, device) -> dict:
    """Point constants for one (pk, spk) pair on `device`, cached on pk."""
    cache = pk._dev.setdefault(("ballot_dev", str(device)), {})
    if cache.get("key") != id(spk):
        bases = [rc.g1_gen] + spk.s_pts + [spk.x_psi]
        cache.update(
            key=id(spk),
            g1_fixed=co.g1_to_device([pk.delta_g1] * 3 + bases, device),
            alpha=co.g1_to_device([pk.alpha_g1], device),
            beta1=co.g1_to_device([pk.beta_g1], device),
            beta2=co.g2_to_device([pk.beta_g2], device),
            delta2=co.g2_to_device([pk.delta_g2], device),
            p_bases=message_bases(gvk, spk.n),
        )
    return cache


def draw_scalars(B: int, rng: FrRandom) -> dict:
    """The tail's randomness for B ballots in the host path's draw order,
    and the scalars derived from it."""
    rs = [(rng(), rng()) for _ in range(B)]  # blinding (r, s)
    r_enc = [rng() for _ in range(B)]  # encryption r
    rnds = [[rng() for _ in range(3)] for _ in range(B)]  # rerandomize
    zs = []
    for rnd in rnds:
        z1, z2, r2 = (x % R for x in rnd)
        zs.append((z1 or 1, z2, r2))
    u = [(r_enc[i] + zs[i][2]) % R for i in range(B)]
    sz = [(rs[i][1] + zs[i][1]) % R for i in range(B)]
    return dict(rs=rs, u=u, sz=sz, z1inv=[pow(z[0], R - 2, R) for z in zs],
                z1=[z[0] for z in zs], z1sz=[zs[i][0] * sz[i] % R for i in range(B)])


def finalize_ballots_device(pk: ProvingKey, spk: SaverPublicKey, gvk: VerificationKey, outs: dict,
                            votes: list[int], rng: FrRandom) -> list[tuple[Ciphertext, Proof]]:
    """MSM outputs (device Jacobian coords, leading dim (B,)) + votes ->
    rerandomized (ciphertext, proof) per ballot, every group operation on
    the outputs' device.  Byte-identical to the host path
    (groth16._blind_and_assemble -> saver.encrypt_many ->
    saver.rerandomize_many) under the same seeded rng."""
    B, n = len(votes), spk.n
    device = outs["a"][0].device
    sc = draw_scalars(B, rng)
    const = _const(pk, spk, gvk, device)

    scal1: list[int] = []
    for i in range(B):
        r_i, s_i = sc["rs"][i]
        scal1 += [r_i % R, s_i % R, r_i * s_i % R] + [sc["u"][i]] * (n + 2)
    scal2 = sc["sz"] + [r % R for r, _ in sc["rs"]] + sc["z1inv"]
    scal_g2 = sc["z1"] + sc["z1sz"]
    digits = [lb.upload(msm_mod.scalars_to_window_digits(s), device) for s in (scal1, scal2, scal_g2)]

    # sparse message term E: slot 1+v gets P_v, the psi slot gets Y_v
    e_flat: list = []
    for v in votes:
        row: list = [None] * (n + 2)
        row[1 + v] = const["p_bases"][v]
        row[n + 1] = spk.y_pts[v]
        e_flat.extend(row)
    e_pts = tuple(c.reshape((B, n + 2) + tuple(c.shape[1:])) for c in co.g1_to_device(e_flat, device))

    a_fin, b_fin, c_fin, ct = _finalize(B, n, const, outs, *digits, e_pts)
    # every G1 result converts to affine in one pass
    flat_ct = tuple(c.reshape((B * (n + 2),) + tuple(c.shape[2:])) for c in ct)
    g1_aff = co.g1_from_device(tuple(torch.cat(cs) for cs in zip(a_fin, c_fin, flat_ct)))
    a_aff, c_aff, ct_aff = g1_aff[:B], g1_aff[B : 2 * B], g1_aff[2 * B :]
    b_aff = co.g2_from_device(b_fin)
    return [(Ciphertext(ct_aff[i * (n + 2) : (i + 1) * (n + 2)]), Proof(a=a_aff[i], b=b_aff[i], c=c_aff[i]))
            for i in range(B)]


def _finalize_host(pk: ProvingKey, spk: SaverPublicKey, gvk: VerificationKey, outs: dict, votes: list[int],
                   sc: dict) -> list[tuple[Ciphertext, Proof]]:
    """The same algebra with native host pointwise multiplies, from the
    scalars of ``draw_scalars``: the oracle of the device tail."""
    B, n = len(votes), spk.n
    a_h = co.g1_from_device(outs["a"])
    b1_h = co.g1_from_device(outs["b1"])
    b2_h = co.g2_from_device(outs["b2"])
    l_h = co.g1_from_device(outs["l"])
    h_h = co.g1_from_device(outs["h"])

    rs = sc["rs"]
    d1 = rj.g1_mul_many([pk.delta_g1] * (3 * B),
                        [r % R for r, _ in rs] + [s % R for _, s in rs] + [r * s % R for r, s in rs])
    bases = [rc.g1_gen] + spk.s_pts + [spk.x_psi]
    u_scalars: list[int] = []
    for i in range(B):
        u_scalars.extend([sc["u"][i]] * (n + 2))
    ct0 = rj.g1_mul_many(bases * B, u_scalars)

    a_bl = [rc.g1_add(rc.g1_add(pk.alpha_g1, a_h[i]), d1[i]) for i in range(B)]
    b1_bl = [rc.g1_add(rc.g1_add(pk.beta_g1, b1_h[i]), d1[B + i]) for i in range(B)]
    r2 = rj.g1_mul_many(a_bl + b1_bl + a_bl, sc["sz"] + [r % R for r, _ in rs] + sc["z1inv"])
    b2s = [rc.g2_add(pk.beta_g2, b2_h[i]) for i in range(B)]
    g2r = rj.g2_mul_many(b2s + [pk.delta_g2] * B, sc["z1"] + sc["z1sz"])

    p_bases = message_bases(gvk, n)
    out = []
    for i in range(B):
        a_fin = r2[2 * B + i]
        b_fin = rc.g2_add(g2r[i], g2r[B + i])
        c_fin = rc.g1_add(rc.g1_add(rc.g1_add(l_h[i], h_h[i]), r2[i]),
                          rc.g1_add(r2[B + i], rc.g1_neg(d1[2 * B + i])))
        seg = list(ct0[i * (n + 2) : (i + 1) * (n + 2)])
        v = votes[i]
        seg[1 + v] = rc.g1_add(seg[1 + v], p_bases[v])
        seg[n + 1] = rc.g1_add(seg[n + 1], spk.y_pts[v])
        out.append((Ciphertext(seg), Proof(a=a_fin, b=b_fin, c=c_fin)))
    return out
