"""High-level SDK — the JS/WASM wrapper's API surface (L3), in Python.

Mirrors share/wasm/wrapper.js's six-function API name-for-name
(generate_voter_keypair, admin_keygen, init_election, generate_vote,
tally_votes, verify_tally; wrapper.js:89-378) so an application written
against the reference SDK maps one-to-one.  All values are bytes blobs in
the wire formats of protocol.marshal, exactly as the JS SDK shuttles
Uint8Arrays.  The same surface is exported over a C ABI by
frontends/c_api.py for non-Python embedders (the WASM/JNI/ObjC analog).

Counterpart of ``vote_saver_tpu/sdk.py``: the same dataclasses and nine
functions.  Those whose phases run on a device (``admin_keygen``,
``init_election``, ``generate_vote``, ``generate_votes``) take
``device="cuda"`` and pass it on; where the JAX package picks its backend
from the environment (``backend.py``), the caller names it here.  The
others run host code, as their phases do.
"""

from __future__ import annotations

import dataclasses

from .params import DEFAULT_EID_BITS, DEFAULT_TREE_DEPTH
from .protocol import marshal as M
from .protocol import phases
from .utils.rng import FrRandom


@dataclasses.dataclass
class VoterKeypair:
    public_key: bytes
    secret_key: bytes


@dataclasses.dataclass
class AdminKeys:
    """The admin keygen bundle.  Non-admin embedders (the mobile/WASM voter
    clients) hold only the public parts, so everything past the CRS pair
    defaults to empty: generate_vote needs public_key, verify_tally needs
    verification_key, and only tally_votes (admin-side) needs secret_key."""

    r1cs_proving_key: bytes
    r1cs_verification_key: bytes
    public_key: bytes = b""        # SAVER pk_eid
    secret_key: bytes = b""        # SAVER sk_eid
    verification_key: bytes = b""  # SAVER vk_eid


@dataclasses.dataclass
class Election:
    eid: bytes
    rt: bytes
    merkle_tree: bytes


@dataclasses.dataclass
class Ballot:
    proof: bytes          # 192 bytes
    primary_input: bytes  # packed eid ‖ sn ‖ rt scalar vector
    ct: bytes             # n+2 compressed G1 points
    sn: bytes             # packed sn scalar vector


def generate_voter_keypair(rng: FrRandom | None = None) -> VoterKeypair:
    pk, sk = phases.init_voter_phase(0, rng)
    return VoterKeypair(public_key=pk, secret_key=sk)


def admin_keygen(tree_depth: int = DEFAULT_TREE_DEPTH,
                 eid_bits: int = DEFAULT_EID_BITS,
                 rng: FrRandom | None = None, device="cuda") -> AdminKeys:
    """Setup on `device`, or host-native with "host" (the keys are the same)."""
    return AdminKeys(*phases.init_admin_phase_generate_keys(tree_depth, eid_bits, rng, device))


def init_election(public_keys: list[bytes], tree_depth: int = DEFAULT_TREE_DEPTH,
                  eid_bits: int = DEFAULT_EID_BITS,
                  rng: FrRandom | None = None, device="cuda") -> Election:
    """The Merkle tree on `device`, or through the oracle with "host"."""
    return Election(*phases.init_admin_phase_generate_data(tree_depth, eid_bits, public_keys, rng, device))


def generate_vote(keys: AdminKeys, election: Election, voter_idx: int, vote: int,
                  secret_key: bytes, tree_depth: int = DEFAULT_TREE_DEPTH,
                  eid_bits: int = DEFAULT_EID_BITS,
                  rng: FrRandom | None = None, device="cuda") -> Ballot:
    out = phases.vote_phase(
        tree_depth, eid_bits, voter_idx, vote,
        election.merkle_tree, election.rt, election.eid, secret_key,
        keys.public_key, keys.r1cs_proving_key, keys.r1cs_verification_key, rng, device,
    )
    return Ballot(*out)


def generate_votes(keys: AdminKeys, election: Election, voter_indices: list[int],
                   votes: list[int], secret_keys: list[bytes],
                   tree_depth: int = DEFAULT_TREE_DEPTH,
                   eid_bits: int = DEFAULT_EID_BITS,
                   rng: FrRandom | None = None, device="cuda") -> list[Ballot]:
    """Batched ballot generation — the TPU-native extension of the JS API."""
    outs = phases.vote_phase_batch(
        tree_depth, eid_bits, voter_indices, votes,
        election.merkle_tree, election.rt, election.eid, secret_keys,
        keys.public_key, keys.r1cs_proving_key, keys.r1cs_verification_key, rng, device,
    )
    return [Ballot(*o) for o in outs]


def verify_vote(keys: AdminKeys, ballot: Ballot) -> bool:
    """Off-chain ballot check (vergrth16-equivalent; not in the JS API but
    required by the on-chain flow)."""
    return phases.verify_ballot(
        ballot.proof, ballot.primary_input, ballot.ct,
        keys.verification_key, keys.r1cs_verification_key,
    )


def tally_votes(keys: AdminKeys, cts: list[bytes],
                tree_depth: int = DEFAULT_TREE_DEPTH) -> tuple[bytes, bytes]:
    """Returns (dec_proof, voting_res); voting_res holds the 25 counts."""
    return phases.tally_admin_phase(
        tree_depth, cts, keys.secret_key, keys.verification_key,
        keys.r1cs_proving_key, keys.r1cs_verification_key,
    )


def verify_tally(keys: AdminKeys, cts: list[bytes], voting_res: bytes,
                 dec_proof: bytes, tree_depth: int = DEFAULT_TREE_DEPTH) -> bool:
    return phases.tally_voter_phase(
        tree_depth, cts, keys.verification_key,
        keys.r1cs_proving_key, keys.r1cs_verification_key, voting_res, dec_proof,
    )


def decode_result(voting_res: bytes) -> list[int]:
    """voting_res blob -> per-candidate counts (wrapper.js:277-282 analog)."""
    return M.de_scalar_vector_any(voting_res)
