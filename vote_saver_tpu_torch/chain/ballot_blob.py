"""The on-chain verifier-input blob `vi` and its VERGRTH16-equivalent check.

Layout (reference README.md:117-135, notebook cell 0/20, main.cpp:690-698):

    vi = mode(1B) ‖ proof(192B) ‖ vk_crs ‖ pk_eid ‖ vk_eid ‖ ct ‖ eid ‖ sn ‖ rt

with mode 0x01 = encrypted-primary-input Groth16, and the trailing eid/sn/rt
sections *bit-expanded*: one 32-byte big-endian field element (0 or 1) per
bit — 64/255/255 elements, spans 2048/8160/8160 bytes, matching the worked
offsets in README.md:219.  The packed 254-bit-chunk encoding used inside the
proof's primary input is recovered by re-packing the expanded bits.

The middle section (proof_end..ct_begin) carries every key `vergrth16` needs
— vk_crs, pk_eid and the SAVER verification key vk_eid, each self-describing
— so a ballot verifies from vi alone, matching the embedded-key semantics of
the TVM builtin (reference README.md:129-135, voting_voter.sol:94).  vk_eid
rides alongside pk_eid because this framework's ct well-formedness check
(saver.verify_encryption, docs/SAVER_SPEC.md) pairs against V/Z points that
live in the verification key rather than the public key.

One 0x00 pad byte sits between ct_end and eid_begin: the reference contract
enforces `eid_begin > ct_end` STRICTLY (voting_voter.sol:91, require 210)
while its getters slice exclusive-end (`vi[ct_begin:ct_end]`,
voting_voter.sol:121-123), so a contract-acceptable blob needs at least one
byte of slack after the ct section.  Mode 0x00 (plain primary input,
README.md:129-135) is supported via build_vi_plain/vergrth16: the ct section
slot instead carries the serialized public message block and the proof is
checked as ordinary Groth16 over the full primary input.
"""

from __future__ import annotations

import dataclasses

from ..params import DEFAULT_EID_BITS, DIGEST_BITS, MSG_SIZE
from ..protocol import marshal as M

MODE_PLAIN_INPUT = 0x00
MODE_ENCRYPTED_INPUT = 0x01


@dataclasses.dataclass
class BallotSections:
    """Byte offsets within vi (SharedStructs.Ballot, voting_interface.sol:17-25)."""

    proof_end: int
    ct_begin: int
    ct_end: int
    eid_begin: int
    sn_begin: int
    rt_begin: int


def _expand_bits(bits) -> bytes:
    return b"".join(int(b).to_bytes(32, "big") for b in bits)


def _collapse_bits(blob: bytes) -> list[int]:
    assert len(blob) % 32 == 0
    out = []
    for i in range(0, len(blob), 32):
        v = int.from_bytes(blob[i : i + 32], "big")
        assert v in (0, 1), "expanded bit section holds non-bit element"
        out.append(v)
    return out


def build_vi(
    proof_blob: bytes,
    vk_crs_blob: bytes,
    pk_eid_blob: bytes,
    ct_blob: bytes,
    eid_bits: list[int],
    sn_bits: list[int],
    rt_bits: list[int],
    vk_eid_blob: bytes = b"",
) -> tuple[bytes, BallotSections]:
    assert len(proof_blob) == 192
    parts = [
        bytes([MODE_ENCRYPTED_INPUT]), proof_blob, vk_crs_blob, pk_eid_blob,
        vk_eid_blob, ct_blob,
    ]
    off = sum(len(p) for p in parts)
    # pad byte: the contract requires eid_begin > ct_end strictly
    # (voting_voter.sol:91) while slicing ct exclusive-end (sol:121-123)
    sec = BallotSections(
        proof_end=1 + 192,
        ct_begin=off - len(ct_blob),
        ct_end=off,
        eid_begin=off + 1,
        sn_begin=off + 1 + 32 * len(eid_bits),
        rt_begin=off + 1 + 32 * (len(eid_bits) + len(sn_bits)),
    )
    parts += [b"\x00", _expand_bits(eid_bits), _expand_bits(sn_bits), _expand_bits(rt_bits)]
    return b"".join(parts), sec


def build_vi_plain(
    proof_blob: bytes,
    vk_crs_blob: bytes,
    m_field: list[int],
    eid_bits: list[int],
    sn_bits: list[int],
    rt_bits: list[int],
) -> tuple[bytes, BallotSections]:
    """Mode-0x00 blob: plain (unencrypted) primary input (README.md:129-135).

    The ct section slot carries the serialized public message block (the
    first msg_size primary-input scalars) instead of an ElGamal ciphertext;
    the trailing eid/sn/rt sections are bit-expanded exactly as in mode 0x01.
    """
    assert len(proof_blob) == 192
    m_blob = M.ser_scalar_vector(m_field)
    parts = [bytes([MODE_PLAIN_INPUT]), proof_blob, vk_crs_blob, m_blob]
    off = sum(len(p) for p in parts)
    sec = BallotSections(
        proof_end=1 + 192,
        ct_begin=off - len(m_blob),
        ct_end=off,
        eid_begin=off + 1,
        sn_begin=off + 1 + 32 * len(eid_bits),
        rt_begin=off + 1 + 32 * (len(eid_bits) + len(sn_bits)),
    )
    parts += [b"\x00", _expand_bits(eid_bits), _expand_bits(sn_bits), _expand_bits(rt_bits)]
    return b"".join(parts), sec


def split_vi(vi: bytes, sec: BallotSections):
    """Slice vi into its sections (the voter contract's getters)."""
    return {
        "mode": vi[0],
        "proof": vi[1 : sec.proof_end],
        "middle": vi[sec.proof_end : sec.ct_begin],  # vk_crs ‖ pk_eid ‖ vk_eid
        "ct": vi[sec.ct_begin : sec.ct_end],
        "eid": vi[sec.eid_begin : sec.sn_begin],
        "sn": vi[sec.sn_begin : sec.rt_begin],
        "rt": vi[sec.rt_begin :],
    }


def vergrth16(vi: bytes, sec: BallotSections, eid_bits_len: int = DEFAULT_EID_BITS) -> bool:
    """The TVM builtin's off-chain equivalent (voting_voter.sol:94): verify
    the Groth16 proof with the mode byte selecting plain (0x00) vs
    ElGamal-encrypted (0x01) primary input (README.md:129-135)."""
    from ..protocol import saver

    try:
        s = split_vi(vi, sec)
        if s["mode"] == MODE_PLAIN_INPUT:
            return _vergrth16_plain(s)
        if s["mode"] != MODE_ENCRYPTED_INPUT:
            return False
        proof = M.de_proof(s["proof"])
        # middle = vk_crs ‖ pk_eid ‖ vk_eid; every part self-describing
        middle = s["middle"]
        vk, off = _de_vk_prefix(middle)
        pk_len = _saver_pk_len(middle, off)
        M.de_saver_pk(middle[off : off + pk_len])  # well-formedness
        svk = M.de_saver_vk(middle[off + pk_len :])
        ct = M.de_ct(s["ct"])
        eid_bits = _collapse_bits(s["eid"])
        sn_bits = _collapse_bits(s["sn"])
        rt_bits = _collapse_bits(s["rt"])
        rest = (
            M.pack_bits_to_field_elements(eid_bits)
            + M.pack_bits_to_field_elements(sn_bits)
            + M.pack_bits_to_field_elements(rt_bits)
        )
        return saver.verify_encryption(vk, svk, ct, proof, rest)
    except (AssertionError, IndexError, ValueError, KeyError):
        return False


def _vergrth16_plain(s: dict) -> bool:
    """Mode 0x00: ordinary Groth16 verification over the plain primary input
    [m ‖ packed eid ‖ packed sn ‖ packed rt] (reference README.md:133-134)."""
    from ..protocol import groth16

    proof = M.de_proof(s["proof"])
    vk, off = _de_vk_prefix(s["middle"])
    if off != len(s["middle"]):
        return False
    m_field = M.de_scalar_vector(s["ct"])
    primary = (
        m_field
        + M.pack_bits_to_field_elements(_collapse_bits(s["eid"]))
        + M.pack_bits_to_field_elements(_collapse_bits(s["sn"]))
        + M.pack_bits_to_field_elements(_collapse_bits(s["rt"]))
    )
    return groth16.verify(vk, primary, proof)


def _de_vk_prefix(blob: bytes):
    """Parse a Groth16 vk blob from the head of `blob`; return (vk, length)."""
    import struct

    base = M.G1_SIZE + 3 * M.G2_SIZE
    (n_ic,) = struct.unpack(">Q", blob[base : base + 8])
    length = base + 8 + n_ic * M.G1_SIZE
    return M.de_groth16_vk(blob[:length]), length


def _saver_pk_len(blob: bytes, off: int) -> int:
    """Length of a serialized SaverPublicKey at `blob[off:]` — two 8-byte
    length-prefixed G1 vectors around one bare G1 (marshal.ser_saver_pk)."""
    import struct

    (n_s,) = struct.unpack(">Q", blob[off : off + 8])
    mid = off + 8 + (n_s + 1) * M.G1_SIZE
    (n_y,) = struct.unpack(">Q", blob[mid : mid + 8])
    return mid + 8 + n_y * M.G1_SIZE - off
