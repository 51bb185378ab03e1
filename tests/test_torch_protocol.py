"""The port's jax-free protocol copies against the JAX package, byte for byte.

The port carries its own copies of the host SAVER functions, the key/proof
parsers and the Merkle host arm (their JAX modules import jax).  Under one
seeded ``FrRandom`` both sides must give identical bytes: voter keys and
election data, SAVER keygen, encryption and rerandomization, and the parsed
blobs of the depth-2 election re-serialize to themselves.
"""

import numpy as np
import pytest

from vote_saver_tpu.params import MSG_SIZE
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.protocol import phases as jphases
from vote_saver_tpu.protocol import saver as jsaver
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch.ops import merkle
from vote_saver_tpu_torch.protocol import keys
from vote_saver_tpu_torch.protocol import phases as tphases
from vote_saver_tpu_torch.protocol import saver as tsaver
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_voter_keys_and_election_data_match_jax():
    ours = [tphases.init_voter_phase(i, FrRandom(31)) for i in range(3)]
    theirs = [jphases.init_voter_phase(i, FrRandom(31)) for i in range(3)]
    assert ours == theirs
    pks = [v[0] for v in ours]
    assert tphases.init_admin_phase_generate_data(2, 64, pks, FrRandom(32)) == \
        jphases.init_admin_phase_generate_data(2, 64, pks, FrRandom(32))
    levels = merkle.unflatten_tree(M.de_merkle_tree(tphases.init_admin_phase_generate_data(
        2, 64, pks, FrRandom(32))[2], 2), 2)
    assert [len(lv) for lv in levels] == [4, 2, 1]
    assert merkle.copath(levels, 2).shape == (2, 255)
    assert np.array_equal(merkle.copath(levels, 2)[0], levels[0][3])


def test_blobs_parse_and_reserialize(election):
    e = election
    assert M.ser_saver_pk(keys.de_saver_pk(e["pk_eid"])) == e["pk_eid"]
    assert M.ser_saver_vk(keys.de_saver_vk(e["vk_eid"])) == e["vk_eid"]
    assert M.ser_saver_sk(keys.de_saver_sk(e["sk_eid"])) == e["sk_eid"]
    assert M.ser_groth16_vk(keys.de_groth16_vk(e["vk_crs"])) == e["vk_crs"]
    for proof, _pinput, ct, _sn in e["ballots"]:
        assert M.ser_proof(keys.de_proof(proof)) == proof
        assert M.ser_ct(keys.de_ct(ct)) == ct


def test_saver_host_arm_matches_jax(election):
    e = election
    vk_t, vk_j = keys.de_groth16_vk(e["vk_crs"]), M.de_groth16_vk(e["vk_crs"])
    rnd = [FrRandom(33)() for _ in range(MSG_SIZE * 3 + 2)]
    ours, theirs = tsaver.keygen(vk_t, MSG_SIZE, rnd), jsaver.keygen(vk_j, MSG_SIZE, rnd)
    for ser, a, b in zip((M.ser_saver_pk, M.ser_saver_sk, M.ser_saver_vk), ours, theirs):
        assert ser(a) == ser(b)
    spk_t, spk_j = keys.de_saver_pk(e["pk_eid"]), M.de_saver_pk(e["pk_eid"])
    ms = [[int(i == v) for i in range(MSG_SIZE)] for v in e["votes"]]
    rs = [FrRandom(34)() for _ in ms]
    cts_t = tsaver.encrypt_many(spk_t, vk_t, ms, rs)
    cts_j = jsaver.encrypt_many(spk_j, vk_j, ms, rs)
    assert [M.ser_ct(c) for c in cts_t] == [M.ser_ct(c) for c in cts_j]
    proofs_t = [keys.de_proof(b[0]) for b in e["ballots"]]
    proofs_j = [M.de_proof(b[0]) for b in e["ballots"]]
    rnds = [[FrRandom(35 + i)() for _ in range(3)] for i in range(len(ms))]
    pk_t = keys.de_groth16_pk(e["pk_crs"], coo=None)
    out_t = tsaver.rerandomize_many(spk_t, pk_t.delta_g2, cts_t, proofs_t, rnds)
    out_j = jsaver.rerandomize_many(spk_j, pk_t.delta_g2, cts_j, proofs_j, rnds)
    assert [(M.ser_ct(c), M.ser_proof(p)) for c, p in out_t] == [(M.ser_ct(c), M.ser_proof(p)) for c, p in out_j]
    # a rerandomized ballot still verifies, under both verifiers
    svk_t, svk_j = keys.de_saver_vk(e["vk_eid"]), M.de_saver_vk(e["vk_eid"])
    rest = M.de_scalar_vector(e["ballots"][0][1])
    (ct, proof), (jct, jproof) = out_t[0], out_j[0]
    assert tsaver.verify_encryption(vk_t, svk_t, ct, proof, rest)
    assert jsaver.verify_encryption(vk_j, svk_j, jct, jproof, rest)
    # an encryption of another vote (voter 2: 17, not 5) does not
    assert e["votes"][2] != e["votes"][0]
    assert not tsaver.verify_encryption(vk_t, svk_t, cts_t[2], proof, rest)
