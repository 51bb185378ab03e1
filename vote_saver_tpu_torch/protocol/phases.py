"""The protocol phases of the slice: voter and admin setup, the vote phase
and ballot verification.

Counterpart of ``vote_saver_tpu/protocol/phases.py``.  Blob-in/blob-out as
there; the vote phase is batched over voters and takes the path the JAX
package runs with ``VSTPU_HOST_WITNESS``: host witness
(``circ.generate_witness``) -> device prover (A/B/C, R1CS check, NTTs, five
scheduled MSMs on the CUDA kernels) -> host tail (blinding, SAVER encrypt,
rerandomize) -> serialization.  Randomness comes from one seeded
``FrRandom`` drawn in exactly the JAX order, so ballots are byte-identical
to the JAX package's under the same seed.
"""

from __future__ import annotations

import numpy as np

from vote_saver_tpu.circuit.voting import build_voting_circuit
from vote_saver_tpu.params import DEFAULT_EID_BITS, MSG_SIZE, PUBLIC_KEY_BITS, SECRET_KEY_BITS
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.refimpl import pedersen as rpd
from vote_saver_tpu.utils.rng import FrRandom

from ..ops import merkle
from . import groth16, keys, saver


def init_voter_phase(voter_idx: int, rng: FrRandom | None = None) -> tuple[bytes, bytes]:
    """Random 255-bit sk; pk = Pedersen(sk).  Returns (pk_blob, sk_blob)."""
    rng = rng or FrRandom()
    sk_bits = rng.bits(SECRET_KEY_BITS)
    return M.ser_bitarray(rpd.pedersen_hash(sk_bits)), M.ser_bitarray(sk_bits)


def init_admin_phase_generate_keys(tree_depth: int, eid_bits: int = DEFAULT_EID_BITS,
                                   rng: FrRandom | None = None):
    """R1CS for the tree depth, Groth16 setup, SAVER keys from msg_size*3+2
    scalars.  Returns (pk_crs, vk_crs, pk_eid, sk_eid, vk_eid) blobs."""
    rng = rng or FrRandom()
    circ = build_voting_circuit(tree_depth, eid_bits)
    pk, vk = groth16.setup(circ.cs, rng)
    rnd = [rng() for _ in range(MSG_SIZE * 3 + 2)]
    spk, ssk, svk = saver.keygen(vk, MSG_SIZE, rnd)
    return (M.ser_groth16_pk(pk), M.ser_groth16_vk(vk), M.ser_saver_pk(spk),
            M.ser_saver_sk(ssk), M.ser_saver_vk(svk))


def init_admin_phase_generate_data(tree_depth: int, eid_bits: int, public_keys_blobs: list[bytes],
                                   rng: FrRandom | None = None):
    """Merkle tree over <= 2^depth voter pks (zero-padded), random eid.
    Returns (eid_blob, rt_blob, merkle_tree_blob)."""
    rng = rng or FrRandom()
    n = 1 << tree_depth
    if len(public_keys_blobs) > n:
        raise ValueError(f"{len(public_keys_blobs)} voters do not fit a depth-{tree_depth} tree")
    pks = [M.de_bitarray(b, PUBLIC_KEY_BITS) for b in public_keys_blobs]
    pks += [[0] * PUBLIC_KEY_BITS] * (n - len(pks))
    levels = merkle.build_tree(np.array(pks, np.int32))
    rt_field = M.pack_bits_to_field_elements([int(b) for b in merkle.root(levels)])
    eid_field = M.pack_bits_to_field_elements([rng() % 2 for _ in range(eid_bits)])
    return (M.ser_scalar_vector(eid_field), M.ser_scalar_vector(rt_field),
            M.ser_merkle_tree(merkle.flatten_tree(levels)))


class VoteContext:
    """Parsed election state for repeated ballot generation; the CRS point
    tensors are built on ``device`` at first use and stay there."""

    def __init__(self, tree_depth, eid_bits, circ, levels, eid_field, eid, spk, vk, pk, device):
        self.tree_depth = tree_depth
        self.eid_bits = eid_bits
        self.circ = circ
        self.levels = levels
        self.eid_field = eid_field
        self.eid = eid
        self.spk = spk
        self.vk = vk
        self.pk = pk
        self.device = device


def prepare_vote_context(tree_depth: int, eid_bits: int, merkle_tree_blob: bytes, rt_blob: bytes,
                         eid_blob: bytes, pk_eid_blob: bytes, proving_key_blob: bytes,
                         verification_key_blob: bytes, device="cpu") -> VoteContext:
    circ = build_voting_circuit(tree_depth, eid_bits)
    levels = merkle.unflatten_tree(M.de_merkle_tree(merkle_tree_blob, tree_depth), tree_depth)
    rt_bits = [int(b) for b in merkle.root(levels)]
    if M.pack_bits_to_field_elements(rt_bits) != M.de_scalar_vector(rt_blob):
        raise ValueError("merkle root mismatch")
    eid_field = M.de_scalar_vector(eid_blob)
    eid = M.unpack_field_elements_to_bits(eid_field, eid_bits)
    spk = keys.de_saver_pk(pk_eid_blob)
    vk = keys.de_groth16_vk(verification_key_blob)
    pk = keys.de_groth16_pk(proving_key_blob, coo=circ.cs.to_coo())
    return VoteContext(tree_depth, eid_bits, circ, levels, eid_field, eid, spk, vk, pk, device)


def _finish_host(spk, vk, pk, proofs, prim, B: int, rng: FrRandom):
    """Host tail: SAVER encrypt + rerandomize; [(ct, proof)] per ballot."""
    m_fields = [[int(x) for x in prim[i, :MSG_SIZE]] for i in range(B)]
    cts0 = saver.encrypt_many(spk, vk, m_fields, [rng() for _ in range(B)])
    return saver.rerandomize_many(
        spk, pk.delta_g2, cts0, proofs, [[rng() for _ in range(3)] for _ in range(B)]
    )


def vote_with_context(ctx: VoteContext, voter_indices: list[int], votes: list[int],
                      sk_blobs: list[bytes], rng: FrRandom | None = None,
                      timer: groth16.StageTimer | None = None):
    """Per voter (proof_blob, pinput_blob, ct_blob, sn_blob), as the JAX
    package's vote_with_context.  ``timer`` records per-stage seconds."""
    rng = rng or FrRandom()
    B = len(voter_indices)
    if len(votes) != B or len(sk_blobs) != B:
        raise ValueError("one vote and one secret key per voter index")
    if any(not 0 <= idx < (1 << ctx.tree_depth) for idx in voter_indices):
        raise ValueError("Voter index should be less than number of participants!")
    circ = ctx.circ
    sks = [M.de_bitarray(b, SECRET_KEY_BITS) for b in sk_blobs]
    sib = np.stack([merkle.copath(ctx.levels, i) for i in voter_indices]).astype(object)
    wit = circ.generate_witness(
        np.array(votes), np.array(ctx.eid, dtype=object), np.array(sks, dtype=object),
        np.array(voter_indices), sib,
    )
    if timer:
        timer.mark("witness")
    proofs = groth16.prove(ctx.pk, wit.values, rng, ctx.device, timer=timer)
    prim = wit.primary(circ.cs.num_primary)
    rerand = _finish_host(ctx.spk, ctx.vk, ctx.pk, proofs, prim, B, rng)
    out = []
    sn_off = MSG_SIZE + len(ctx.eid_field)
    for i in range(B):
        ct, proof = rerand[i]
        pinput = [int(x) for x in prim[i]]
        out.append((
            M.ser_proof(proof),
            M.ser_scalar_vector(pinput[MSG_SIZE:]),
            M.ser_ct(ct),
            M.ser_scalar_vector(pinput[sn_off : sn_off + 2]),
        ))
    if timer:
        timer.mark("tail")
    return out


def verify_ballot(proof_blob: bytes, pinput_blob: bytes, ct_blob: bytes, vk_eid_blob: bytes,
                  vk_crs_blob: bytes) -> bool:
    """Groth16-in-SAVER pairing check plus ciphertext well-formedness."""
    return saver.verify_encryption(
        keys.de_groth16_vk(vk_crs_blob), keys.de_saver_vk(vk_eid_blob), keys.de_ct(ct_blob),
        keys.de_proof(proof_blob), M.de_scalar_vector(pinput_blob),
    )
