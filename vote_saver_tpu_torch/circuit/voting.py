"""The encrypted-input voting circuit.

Statement (public input, in the reference's allocation order —
common.hpp:858-876):  [ m(25) | eid_packed(1) | sn_packed(2) | rt_packed(2) ]

Witness: voter secret key bits, Merkle address + copath, and all hash
internals, proving:
  * m is a one-hot ballot over MSG_SIZE candidates;
  * pk = Pedersen(sk) is registered: H(pk) sits at `address` under root rt;
  * sn = Pedersen(eid ‖ sk) — with a canonical (unique) bit decomposition,
    which is what makes the on-chain sn-uniqueness double-vote check sound.

Builds once per (tree_depth, eid_bits); witness generation is batched over
voters (the reference rebuilds the circuit and walks witnesses voter-by-voter,
common.hpp:1054-1128).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..params import R, MSG_SIZE, SECRET_KEY_BITS, DIGEST_BITS, CHUNK_SIZE, DEFAULT_EID_BITS
from .r1cs import ConstraintSystem, Witness, lc, ONE
from . import gadgets as g


@dataclasses.dataclass
class VotingCircuit:
    cs: ConstraintSystem
    tree_depth: int
    eid_bits: int
    # primary layout offsets (within the primary input, 0-based)
    m_offset: int = 0
    eid_offset: int = MSG_SIZE
    sn_offset: int = MSG_SIZE + 1
    rt_offset: int = MSG_SIZE + 3
    primary_size: int = MSG_SIZE + 5
    # gadget handles (filled by build)
    _parts: dict = dataclasses.field(default_factory=dict)

    def generate_witness(
        self,
        vote_idx: np.ndarray,
        eid_bits_le: np.ndarray,
        sk_bits: np.ndarray,
        voter_idx: np.ndarray,
        sib_bits: np.ndarray,
    ) -> Witness:
        """All inputs batched over voters (leading dim):
        vote_idx (n,), eid_bits_le (n, eid_bits) or (eid_bits,), sk_bits
        (n, 255), voter_idx (n,), sib_bits (n, depth, 255) bottom-up copaths.
        """
        n = np.asarray(vote_idx).shape[0]
        p = self._parts
        wit = Witness.zeros(n, self.cs.num_vars)
        p["one_hot"].gen_witness(wit, vote_idx)
        eb = np.broadcast_to(np.asarray(eid_bits_le, dtype=object), (n, self.eid_bits))
        for i, v in enumerate(p["eid_bit_vars"]):
            wit.set(v, eb[:, i])
        for i, v in enumerate(p["sk_bit_vars"]):
            wit.set(v, np.asarray(sk_bits, dtype=object)[:, i])
        vidx = np.asarray(voter_idx)
        for l, v in enumerate(p["addr_vars"]):
            wit.set(v, (vidx >> l) & 1)
        sib = np.asarray(sib_bits, dtype=object)
        for l in range(self.tree_depth):
            for i, v in enumerate(p["sib_vars"][l]):
                wit.set(v, sib[:, l, i])
        p["eid_pack"].gen_witness_from_bits(wit)
        p["pk_hash"].gen_witness(wit)
        p["pk_dec"].gen_witness(wit)
        p["leaf_hash"].gen_witness(wit)
        p["leaf_dec"].gen_witness(wit)
        for lvl in p["levels"]:
            lvl.gen_witness(wit)
        p["rt_pack"].gen_witness_from_bits(wit)
        p["sn_hash"].gen_witness(wit)
        p["sn_dec"].gen_witness(wit)
        p["sn_pack"].gen_witness_from_bits(wit)
        return wit


def _unwrap_bit_vars(bit_lcs):
    out = []
    for b in bit_lcs:
        (var, coeff), = b.items()
        assert coeff == 1
        out.append(var)
    return out


@functools.cache
def build_voting_circuit(tree_depth: int, eid_bits: int = DEFAULT_EID_BITS) -> VotingCircuit:
    cs = ConstraintSystem()
    parts: dict = {}

    # --- primary input, in the reference's order -----------------------------
    m_vars = cs.alloc_vec(MSG_SIZE)
    eid_packed = cs.alloc_vec((eid_bits + CHUNK_SIZE - 1) // CHUNK_SIZE)
    sn_packed = cs.alloc_vec((DIGEST_BITS + CHUNK_SIZE - 1) // CHUNK_SIZE)
    rt_packed = cs.alloc_vec((DIGEST_BITS + CHUNK_SIZE - 1) // CHUNK_SIZE)
    cs.set_input_sizes(cs.num_vars - 1)
    assert cs.num_primary == MSG_SIZE + 1 + 2 + 2

    # --- auxiliary inputs ----------------------------------------------------
    parts["one_hot"] = g.OneHot(cs, m_vars)
    eid_bit_vars = cs.alloc_vec(eid_bits)
    sk_bit_vars = cs.alloc_vec(SECRET_KEY_BITS)
    addr_vars = cs.alloc_vec(tree_depth)
    sib_vars = [cs.alloc_vec(DIGEST_BITS) for _ in range(tree_depth)]
    for v in eid_bit_vars + sk_bit_vars + addr_vars:
        g.constrain_boolean(cs, v)
    for level in sib_vars:
        for v in level:
            g.constrain_boolean(cs, v)
    parts["eid_bit_vars"] = eid_bit_vars
    parts["sk_bit_vars"] = sk_bit_vars
    parts["addr_vars"] = addr_vars
    parts["sib_vars"] = sib_vars

    parts["eid_pack"] = g.Packing(cs, eid_bit_vars, eid_packed)

    sk_lcs = [lc((v, 1)) for v in sk_bit_vars]
    parts["pk_hash"] = g.PedersenGadget(cs, sk_lcs)
    parts["pk_dec"] = g.DigestDecompose(cs, parts["pk_hash"].out[0])
    pk_lcs = [lc((b, 1)) for b in parts["pk_dec"].bits]

    parts["leaf_hash"] = g.PedersenGadget(cs, pk_lcs)
    parts["leaf_dec"] = g.DigestDecompose(cs, parts["leaf_hash"].out[0])

    cur = [lc((b, 1)) for b in parts["leaf_dec"].bits]
    levels = []
    for l in range(tree_depth):
        lvl = g.MerkleLevel(cs, cur, sib_vars[l], addr_vars[l])
        levels.append(lvl)
        cur = lvl.out_bits
    parts["levels"] = levels
    parts["rt_pack"] = g.Packing(cs, _unwrap_bit_vars(cur), rt_packed)

    eid_lcs = [lc((v, 1)) for v in eid_bit_vars]
    parts["sn_hash"] = g.PedersenGadget(cs, eid_lcs + sk_lcs)
    parts["sn_dec"] = g.DigestDecompose(cs, parts["sn_hash"].out[0], canonical=True)
    parts["sn_pack"] = g.Packing(cs, parts["sn_dec"].bits, sn_packed)

    circ = VotingCircuit(cs=cs, tree_depth=tree_depth, eid_bits=eid_bits, _parts=parts)
    return circ
