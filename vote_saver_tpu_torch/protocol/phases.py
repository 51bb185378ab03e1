"""The six protocol phases: voter and admin setup, the vote phase (single,
batched, and as a pipelined stream of batches), the tally, and ballot
verification.

Counterpart of ``vote_saver_tpu/protocol/phases.py``, with every public
function of that module.  Blob-in/blob-out as there; the vote phase is
batched over voters, and its device arm takes the JAX package's ``mesh=``
(``parallel.sharded.make_mesh``): every rank of the mesh calls it with the
same arguments, the five MSMs are point-sharded, and every rank gets the
same ballots, byte for byte those of the unsharded call.  Admin key generation runs
Groth16 setup on ``device`` (the card by default), or natively on the host
with ``device="host"`` (the CRS is the same); the election data's Merkle
tree is hashed on ``device`` too, or through the oracle with "host" (the
tree is the same).
The vote phase has the JAX package's two arms, chosen by an explicit
argument, never by the environment:

  * the default, everything on the context's device: device witness
    (``circuit.witness_dev``) -> ``groth16.prove_msms_device`` (A/B/C, R1CS
    check, NTTs, five scheduled MSMs, outputs kept on the device) -> device
    ballot tail (``ballot_dev``: blinding, SAVER encrypt, rerandomize) ->
    serialization;
  * ``host_witness=True``, the arm the JAX package runs under
    ``VSTPU_HOST_WITNESS``: host witness (``circ.generate_witness``) ->
    device prover -> host blinding and host SAVER tail -> serialization.

``vote_with_context_stream`` runs the device arm over a sequence of
batches in the JAX package's pipelined order: batch i+1 is launched (its
MSMs queued, their flags not read) before batch i's tail runs.  The tally
(``tally_admin_phase``, ``tally_voter_phase``) runs on the host, as in the
JAX package: aggregation, decryption and its proof are a few hundred group
operations an election.

Randomness comes from one seeded ``FrRandom`` drawn in exactly the JAX
order, so both arms and the stream give ballots byte-identical to the JAX
package's under the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..circuit import witness_dev
from ..circuit.voting import build_voting_circuit
from ..ops import limbs as lb
from ..ops import merkle
from ..params import DEFAULT_EID_BITS, MSG_SIZE, PUBLIC_KEY_BITS, SECRET_KEY_BITS
from ..refimpl import pedersen as rpd
from ..utils.rng import FrRandom
from . import ballot_dev, groth16, keys, saver
from . import marshal as M


def init_voter_phase(voter_idx: int, rng: FrRandom | None = None) -> tuple[bytes, bytes]:
    """Random 255-bit sk; pk = Pedersen(sk).  Returns (pk_blob, sk_blob)."""
    rng = rng or FrRandom()
    sk_bits = rng.bits(SECRET_KEY_BITS)
    return M.ser_bitarray(rpd.pedersen_hash(sk_bits)), M.ser_bitarray(sk_bits)


def init_admin_phase_generate_keys(tree_depth: int, eid_bits: int = DEFAULT_EID_BITS,
                                   rng: FrRandom | None = None, device="cuda"):
    """R1CS for the tree depth, Groth16 setup (on `device`, or host-native
    when `device` is "host"), SAVER keys from msg_size*3+2 scalars.  Returns
    (pk_crs, vk_crs, pk_eid, sk_eid, vk_eid) blobs."""
    if device != "host":
        device = lb.device_of(device)
    rng = rng or FrRandom()
    circ = build_voting_circuit(tree_depth, eid_bits)
    pk, vk = groth16.setup(circ.cs, rng, device)
    rnd = [rng() for _ in range(MSG_SIZE * 3 + 2)]
    spk, ssk, svk = saver.keygen(vk, MSG_SIZE, rnd)
    return (M.ser_groth16_pk(pk), M.ser_groth16_vk(vk), M.ser_saver_pk(spk),
            M.ser_saver_sk(ssk), M.ser_saver_vk(svk))


def init_admin_phase_generate_data(tree_depth: int, eid_bits: int, public_keys_blobs: list[bytes],
                                   rng: FrRandom | None = None, device="cuda"):
    """Merkle tree over <= 2^depth voter pks (zero-padded), built on
    `device` (or through the oracle with "host"; the tree is the same),
    random eid.  Returns (eid_blob, rt_blob, merkle_tree_blob)."""
    rng = rng or FrRandom()
    n = 1 << tree_depth
    if len(public_keys_blobs) > n:
        raise ValueError(f"{len(public_keys_blobs)} voters do not fit a depth-{tree_depth} tree")
    pks = [M.de_bitarray(b, PUBLIC_KEY_BITS) for b in public_keys_blobs]
    pks += [[0] * PUBLIC_KEY_BITS] * (n - len(pks))
    levels = merkle.build_tree(np.array(pks, np.int32), device)
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

    def on(self, device) -> "VoteContext":
        """This context on `device`: the same parsed election, with a copy
        of the proving key whose device constants are not built yet; what a
        parsed context is sent to another process or card as."""
        return VoteContext(self.tree_depth, self.eid_bits, self.circ, self.levels, self.eid_field, self.eid,
                           self.spk, self.vk, dataclasses.replace(self.pk, _dev={}), lb.device_of(device))


def prepare_vote_context(tree_depth: int, eid_bits: int, merkle_tree_blob: bytes, rt_blob: bytes,
                         eid_blob: bytes, pk_eid_blob: bytes, proving_key_blob: bytes,
                         verification_key_blob: bytes, device="cuda") -> VoteContext:
    device = lb.device_of(device)
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


def vote_phase_batch(tree_depth: int, eid_bits: int, voter_indices: list[int], votes: list[int],
                     merkle_tree_blob: bytes, rt_blob: bytes, eid_blob: bytes, sk_blobs: list[bytes],
                     pk_eid_blob: bytes, proving_key_blob: bytes, verification_key_blob: bytes,
                     rng: FrRandom | None = None, device="cuda"):
    """Batched ballot generation on `device`.  Per voter returns
    (proof_blob, pinput_blob, ct_blob, sn_blob): pinput is the primary
    input from the eid offset on, sn the packed sn slice.  The keys parse
    once per blob (``keys`` caches them), so the device constants built on
    the proving key last across calls."""
    ctx = prepare_vote_context(tree_depth, eid_bits, merkle_tree_blob, rt_blob, eid_blob, pk_eid_blob,
                               proving_key_blob, verification_key_blob, device)
    return vote_with_context(ctx, voter_indices, votes, sk_blobs, rng)


def _finish_host(spk, vk, pk, proofs, prim, B: int, rng: FrRandom):
    """Host tail: SAVER encrypt + rerandomize; [(ct, proof)] per ballot."""
    m_fields = [[int(x) for x in prim[i, :MSG_SIZE]] for i in range(B)]
    cts0 = saver.encrypt_many(spk, vk, m_fields, [rng() for _ in range(B)])
    return saver.rerandomize_many(
        spk, pk.delta_g2, cts0, proofs, [[rng() for _ in range(3)] for _ in range(B)]
    )


def _voter_inputs(ctx: VoteContext, voter_indices: list[int], votes: list[int], sk_blobs: list[bytes]):
    """(secret-key bits, Merkle copaths) of a batch, after checking it."""
    if len(votes) != len(voter_indices) or len(sk_blobs) != len(voter_indices):
        raise ValueError("one vote and one secret key per voter index")
    if any(not 0 <= idx < (1 << ctx.tree_depth) for idx in voter_indices):
        raise ValueError("Voter index should be less than number of participants!")
    sks = [M.de_bitarray(b, SECRET_KEY_BITS) for b in sk_blobs]
    sib = np.stack([merkle.copath(ctx.levels, i) for i in voter_indices]).astype(object)
    return sks, sib


def _primary(ctx: VoteContext, w_np: np.ndarray):
    """Primary inputs (B, num_primary) as ints, from the host copy of the
    standard-form witness."""
    return lb.limbs_to_ints(w_np[:, 1 : 1 + ctx.circ.cs.num_primary], lb.FR)


def _serialize(ctx: VoteContext, rerand, prim) -> list[tuple[bytes, bytes, bytes, bytes]]:
    out = []
    sn_off = MSG_SIZE + len(ctx.eid_field)
    for i, (ct, proof) in enumerate(rerand):
        pinput = [int(x) for x in prim[i]]
        out.append((
            M.ser_proof(proof),
            M.ser_scalar_vector(pinput[MSG_SIZE:]),
            M.ser_ct(ct),
            M.ser_scalar_vector(pinput[sn_off : sn_off + 2]),
        ))
    return out


def vote_with_context(ctx: VoteContext, voter_indices: list[int], votes: list[int],
                      sk_blobs: list[bytes], rng: FrRandom | None = None,
                      timer: groth16.StageTimer | None = None, host_witness: bool = False,
                      ntt: str | None = None, mesh=None):
    """Per voter (proof_blob, pinput_blob, ct_blob, sn_blob), as the JAX
    package's vote_with_context.  ``host_witness`` selects the host-witness
    + host-tail arm; ``ntt`` the prover's NTT path (None: the int8 matmul
    NTT on the card for domains of at least 2^12, else radix-2; or
    "radix2" / "matmul", ``ops.ntt.choose_path``); ``timer`` records
    per-stage seconds; ``mesh`` point-shards the device arm's MSMs (the
    host-witness arm proves without one, so both raise ValueError)."""
    if host_witness and mesh is not None:
        raise ValueError("the host-witness arm proves unsharded: pass host_witness or mesh, not both")
    rng = rng or FrRandom()
    B = len(voter_indices)
    circ = ctx.circ
    sks, sib = _voter_inputs(ctx, voter_indices, votes, sk_blobs)
    if host_witness:
        wit = circ.generate_witness(
            np.array(votes), np.array(ctx.eid, dtype=object), np.array(sks, dtype=object),
            np.array(voter_indices), sib,
        )
        if timer:
            timer.mark("witness")
        proofs = groth16.prove(ctx.pk, wit.values, rng, ctx.device, timer=timer, ntt=ntt)
        prim = wit.primary(circ.cs.num_primary)
        rerand = _finish_host(ctx.spk, ctx.vk, ctx.pk, proofs, prim, B, rng)
        stage = "tail"
    else:
        w_mont = witness_dev.generate_witness_device(
            circ, np.array(votes), ctx.eid, sks, np.array(voter_indices), sib, ctx.device,
        )
        if timer:
            timer.mark("witness")
        outs, _w_std, w_np = groth16.prove_msms_device(ctx.pk, w_mont, timer=timer, ntt=ntt, mesh=mesh)
        prim = _primary(ctx, w_np)
        rerand = ballot_dev.finalize_ballots_device(ctx.pk, ctx.spk, ctx.vk, outs, votes, rng)
        stage = "ballot_tail"
    if timer:
        timer.mark(stage)
    out = _serialize(ctx, rerand, prim)
    if timer:
        timer.mark("serialize")
    return out


def vote_with_context_stream(ctx: VoteContext, batches, rng: FrRandom | None = None,
                             timer: groth16.StageTimer | None = None):
    """Pipelined batched voting over (voter_indices, votes, sk_blobs)
    batches: yields one ballot list per batch.

    Batch i+1 is launched (device witness, A/B/C and H, the host copies of
    w and h, its schedules, its five MSMs queued with their flags left on
    the device) before batch i's tail runs (the one flag read, the device
    ballot tail, serialization), so host work of one batch runs while the
    device works on the other.  All randomness is drawn in the tails, in
    batch order: the ballots are byte-identical to sequential
    ``vote_with_context`` calls under the same seeded `rng`.  The device
    arm only, on the context's device and its one CUDA stream; an
    exception in a launch propagates.  ``timer`` sums every batch's stages
    in the stream's order (``witness``, ``abc_h``, ``schedules`` in a
    launch; ``msm_*``, ``ballot_tail``, ``serialize`` in a tail); its marks
    wait for the device, which a launch does anyway at its R1CS check and a
    tail at its flag read."""
    rng = rng or FrRandom()

    def launch(batch):
        voter_indices, votes, sk_blobs = batch
        sks, sib = _voter_inputs(ctx, voter_indices, votes, sk_blobs)
        w_mont = witness_dev.generate_witness_device(
            ctx.circ, np.array(votes), ctx.eid, sks, np.array(voter_indices), sib, ctx.device,
        )
        if timer:
            timer.mark("witness")
        finish, _w_std, w_np = groth16.prove_msms_device(ctx.pk, w_mont, timer=timer, defer=True)
        return finish, _primary(ctx, w_np), votes

    def tail(state):
        finish, prim, votes = state
        rerand = ballot_dev.finalize_ballots_device(ctx.pk, ctx.spk, ctx.vk, finish(), votes, rng)
        if timer:
            timer.mark("ballot_tail")
        out = _serialize(ctx, rerand, prim)
        if timer:
            timer.mark("serialize")
        return out

    pending = None
    for batch in batches:
        state = launch(batch)
        if pending is not None:
            yield tail(pending)
        pending = state
    if pending is not None:
        yield tail(pending)


def vote_phase(tree_depth: int, eid_bits: int, voter_idx: int, vote: int, merkle_tree_blob: bytes,
               rt_blob: bytes, eid_blob: bytes, sk_blob: bytes, pk_eid_blob: bytes, proving_key_blob: bytes,
               verification_key_blob: bytes, rng: FrRandom | None = None, device="cuda"):
    """Single-voter wrapper with the reference's signature shape."""
    return vote_phase_batch(tree_depth, eid_bits, [voter_idx], [vote], merkle_tree_blob, rt_blob, eid_blob,
                            [sk_blob], pk_eid_blob, proving_key_blob, verification_key_blob, rng, device)[0]


def _aggregate(tree_depth: int, cts_blobs: list[bytes]) -> saver.Ciphertext:
    """The componentwise sum of at most 2^depth ballots' ciphertexts."""
    if not cts_blobs or len(cts_blobs) > (1 << tree_depth):
        raise ValueError(f"{len(cts_blobs)} ciphertexts for a depth-{tree_depth} tree: need 1 to {1 << tree_depth}")
    cts = [keys.de_ct(b) for b in cts_blobs]
    ct_agg = cts[0]
    for ct in cts[1:]:
        ct_agg = ct_agg + ct
    return ct_agg


def tally_admin_phase(tree_depth: int, cts_blobs: list[bytes], sk_eid_blob: bytes, vk_eid_blob: bytes,
                      pk_crs_blob: bytes, vk_crs_blob: bytes) -> tuple[bytes, bytes]:
    """Aggregate the ballots' ciphertexts, decrypt the per-candidate counts
    and prove the decryption.  Returns (dec_proof_blob, voting_res_blob)."""
    ct_agg = _aggregate(tree_depth, cts_blobs)
    counts, dproof = saver.decrypt(keys.de_saver_sk(sk_eid_blob), keys.de_groth16_vk(vk_crs_blob), ct_agg,
                                   max_count=len(cts_blobs))
    if len(counts) != MSG_SIZE:
        raise ValueError(f"{len(counts)} decrypted counts, not {MSG_SIZE}")
    return M.ser_dec_proof(dproof), M.ser_scalar_vector(counts)


def tally_voter_phase(tree_depth: int, cts_blobs: list[bytes], vk_eid_blob: bytes, pk_crs_blob: bytes,
                      vk_crs_blob: bytes, voting_res_blob: bytes, dec_proof_blob: bytes) -> bool:
    """Verify a published tally against the ballots' ciphertexts (the
    result in either prefix width, 8-byte or the chain's 4-byte)."""
    ct_agg = _aggregate(tree_depth, cts_blobs)
    return saver.verify_decryption(keys.de_groth16_vk(vk_crs_blob), keys.de_saver_vk(vk_eid_blob), ct_agg,
                                   M.de_scalar_vector_any(voting_res_blob), keys.de_dec_proof(dec_proof_blob))


def verify_ballot(proof_blob: bytes, pinput_blob: bytes, ct_blob: bytes, vk_eid_blob: bytes,
                  vk_crs_blob: bytes) -> bool:
    """Groth16-in-SAVER pairing check plus ciphertext well-formedness."""
    return saver.verify_encryption(
        keys.de_groth16_vk(vk_crs_blob), keys.de_saver_vk(vk_eid_blob), keys.de_ct(ct_blob),
        keys.de_proof(proof_blob), M.de_scalar_vector(pinput_blob),
    )


# The reference's process_encrypted_input_mode_* names (common.hpp:824-1293).
process_encrypted_input_mode_init_voter_phase = init_voter_phase
process_encrypted_input_mode_init_admin_phase_generate_keys = init_admin_phase_generate_keys
process_encrypted_input_mode_init_admin_phase_generate_data = init_admin_phase_generate_data
process_encrypted_input_mode_vote_phase = vote_phase
process_encrypted_input_mode_tally_admin_phase = tally_admin_phase
process_encrypted_input_mode_tally_voter_phase = tally_voter_phase
