"""The port's tally phases and the rest of its phase API, against the JAX
package on the depth-2 election (``tests/conftest.py``: votes [5, 5, 17]).

The tally runs on the host in both packages (aggregation by ``Ciphertext``
addition, ``saver.decrypt`` and ``verify_decryption`` on the oracle), and
``decrypt`` draws no randomness, so the admin's blobs must be byte-identical;
each package's observer must accept the other's blobs and reject forgeries.
Also here: the single-ballot ``encrypt``/``rerandomize``, the baby-step
giant-step discrete log, the decryption-proof codec, the parse cache the
key parsers share, and the reference-parity aliases.
"""

import random

import pytest

from vote_saver_tpu.protocol import marshal as jM
from vote_saver_tpu.protocol import phases as jphases
from vote_saver_tpu.protocol import saver as jsaver
from vote_saver_tpu_torch.params import MSG_SIZE, R
from vote_saver_tpu_torch.protocol import keys, phases, saver
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.refimpl import curves as rc

DEPTH = 2


def _cts(e):
    return [b[2] for b in e["ballots"]]


@pytest.fixture(scope="module")
def tallies(election):
    """(dec_proof, result) blobs of each package's tally_admin_phase."""
    e = election
    args = (DEPTH, _cts(e), e["sk_eid"], e["vk_eid"], e["pk_crs"], e["vk_crs"])
    return phases.tally_admin_phase(*args), jphases.tally_admin_phase(*args)


def test_tally_admin_blobs_match_jax(tallies):
    ours, theirs = tallies
    assert ours == theirs
    counts = M.de_scalar_vector(ours[1])
    assert counts[5] == 2 and counts[17] == 1 and sum(counts) == 3 and len(counts) == MSG_SIZE
    assert len(ours[1]) == 8 + MSG_SIZE * 32


@pytest.mark.parametrize("verifier", ["port", "jax"])
@pytest.mark.parametrize("author", ["port", "jax"])
def test_tally_verifies_across_packages(election, tallies, author, verifier):
    e = election
    dec_proof, result = tallies[0 if author == "port" else 1]
    verify = phases.tally_voter_phase if verifier == "port" else jphases.tally_voter_phase
    assert verify(DEPTH, _cts(e), e["vk_eid"], e["pk_crs"], e["vk_crs"], result, dec_proof)


def _forge(kind, dec_proof, result):
    counts = M.de_scalar_vector(result)
    if kind == "counts":  # the votes moved between two candidates
        counts[5], counts[17] = 1, 2
        return dec_proof, M.ser_scalar_vector(counts)
    if kind == "swapped_d":  # two of the proof's D points exchanged
        d = keys.de_dec_proof(dec_proof).d_pts
        d[5], d[17] = d[17], d[5]
        return M.ser_dec_proof(saver.DecryptionProof(d_pts=d)), result
    assert kind == "short_result"  # one count short
    return dec_proof, M.ser_scalar_vector(counts[:-1])


@pytest.mark.parametrize("kind", ["counts", "swapped_d", "short_result"])
def test_tally_rejects_forgeries(election, tallies, kind):
    e = election
    dec_proof, result = _forge(kind, *tallies[0])
    for verify in (phases.tally_voter_phase, jphases.tally_voter_phase):
        assert not verify(DEPTH, _cts(e), e["vk_eid"], e["pk_crs"], e["vk_crs"], result, dec_proof)


def test_chain_prefix_result_is_accepted(election, tallies):
    """The chain's 4-byte-prefix result (4 + 25 * 32 bytes) verifies too."""
    e = election
    dec_proof, result = tallies[0]
    counts = M.de_scalar_vector(result)
    chain = M.ser_scalar_vector_chain(counts)
    assert chain == jM.ser_scalar_vector_chain(counts) and len(chain) == 4 + MSG_SIZE * 32
    assert M.de_scalar_vector_any(chain) == M.de_scalar_vector_any(result) == counts
    assert phases.tally_voter_phase(DEPTH, _cts(e), e["vk_eid"], e["pk_crs"], e["vk_crs"], chain, dec_proof)


def test_tally_rejects_what_does_not_fit(election):
    """More ciphertexts than 2^depth voters, none at all, or a count past
    max_count raise ValueError."""
    e = election
    cts = _cts(e)
    for bad in (cts + cts[:2], []):
        with pytest.raises(ValueError):
            phases.tally_admin_phase(DEPTH, bad, e["sk_eid"], e["vk_eid"], e["pk_crs"], e["vk_crs"])
        with pytest.raises(ValueError):
            phases.tally_voter_phase(DEPTH, bad, e["vk_eid"], e["pk_crs"], e["vk_crs"], b"", b"")
    agg = keys.de_ct(cts[0]) + keys.de_ct(cts[1]) + keys.de_ct(cts[2])
    ssk, vk = keys.de_saver_sk(e["sk_eid"]), keys.de_groth16_vk(e["vk_crs"])
    assert saver.decrypt(ssk, vk, agg, max_count=2)[0][5] == 2
    with pytest.raises(ValueError, match="out of range"):
        saver.decrypt(ssk, vk, agg, max_count=1)  # candidate 5 has two votes


@pytest.mark.parametrize("bound", [0, 1, 3, 8, 10])
def test_bsgs_dlog_matches_jax(bound):
    rnd = random.Random(70 + bound)
    base = rc.g1_mul(rc.g1_gen, rnd.randrange(1, R))
    assert saver._bsgs_dlog(base, None, bound) == jsaver._bsgs_dlog(base, None, bound) == 0
    for m in range(bound + 2):
        target = rc.g1_mul(base, m)
        want = m if m <= bound else None
        assert saver._bsgs_dlog(base, target, bound) == jsaver._bsgs_dlog(base, target, bound) == want


def test_single_encrypt_and_rerandomize_match_jax_and_the_batch(election):
    e = election
    spk, vk = keys.de_saver_pk(e["pk_eid"]), keys.de_groth16_vk(e["vk_crs"])
    jspk, jvk = jM.de_saver_pk(e["pk_eid"]), jM.de_groth16_vk(e["vk_crs"])
    delta_g2 = keys.de_groth16_pk(e["pk_crs"], coo=None).delta_g2
    rnd = random.Random(71)
    ms = [[int(i == v) for i in range(MSG_SIZE)] for v in (3, 24)]
    rs = [rnd.randrange(R) for _ in ms]
    cts = [saver.encrypt(spk, vk, m, r) for m, r in zip(ms, rs)]
    assert [c.points for c in cts] == [jsaver.encrypt(jspk, jvk, m, r).points for m, r in zip(ms, rs)]
    assert [c.points for c in cts] == [c.points for c in saver.encrypt_many(spk, vk, ms, rs)]
    proofs = [keys.de_proof(b[0]) for b in e["ballots"][:2]]
    rnds = [[rnd.randrange(R) for _ in range(3)] for _ in ms]
    rnds[1][0] = 0  # z1 = 0 is taken as 1
    ours = [saver.rerandomize(spk, delta_g2, c, p, z) for c, p, z in zip(cts, proofs, rnds)]
    theirs = [jsaver.rerandomize(jspk, delta_g2, jsaver.Ciphertext(c.points), jM.de_proof(b[0]), z)
              for c, b, z in zip(cts, e["ballots"], rnds)]
    assert [(c.points, p.a, p.b, p.c) for c, p in ours] == [(c.points, p.a, p.b, p.c) for c, p in theirs]
    batch = saver.rerandomize_many(spk, delta_g2, cts, proofs, rnds)
    assert [(c.points, p.a, p.b, p.c) for c, p in ours] == [(c.points, p.a, p.b, p.c) for c, p in batch]


def test_dec_proof_and_result_codecs_round_trip(tallies):
    dec_proof, result = tallies[0]
    dp = keys.de_dec_proof(dec_proof)
    assert len(dp.d_pts) == MSG_SIZE and dp.d_pts == jM.de_dec_proof(dec_proof).d_pts
    assert M.ser_dec_proof(dp) == jM.ser_dec_proof(dp) == dec_proof
    with pytest.raises(ValueError):
        keys.de_dec_proof(dec_proof + b"\0")
    counts = M.de_scalar_vector_any(result)
    assert counts == jM.de_scalar_vector_any(result)
    assert M.ser_scalar_vector(counts) == result


def test_key_parsers_share_the_parse_cache(election, monkeypatch):
    """A blob parsed again is the same object (with the device constants
    cached on it), under the JAX package's kind names; the cache keeps at
    most 8 parses, evicting the oldest."""
    e = election
    monkeypatch.setattr(M, "_DE_CACHE", {})
    pk = keys.de_groth16_pk(e["pk_crs"], coo=None)
    coo = {"a": ([], [], [])}
    assert keys.de_groth16_pk(e["pk_crs"], coo=coo) is pk and pk.coo is coo
    assert keys.de_groth16_pk(e["pk_crs"], coo=None).coo is coo
    for parse, blob in ((keys.de_groth16_vk, e["vk_crs"]), (keys.de_saver_pk, e["pk_eid"]),
                        (keys.de_saver_sk, e["sk_eid"]), (keys.de_saver_vk, e["vk_eid"])):
        assert parse(blob) is parse(blob)
    assert sorted(kind for kind, _digest in M._DE_CACHE) == sorted(
        ["g16pk", "de_groth16_vk", "de_saver_pk", "de_saver_sk", "de_saver_vk"])
    for i in range(10):
        M._cached("probe", bytes([i]), lambda i=i: i)
    assert len(M._DE_CACHE) == M._DE_CACHE_MAX == 8
    assert keys.de_groth16_pk(e["pk_crs"], coo=None) is not pk  # evicted, parsed anew


def test_phase_api_is_complete():
    """Every public function of the JAX phases module has its namesake
    here, and the six aliases are the phase functions."""
    public = {n for n, v in vars(jphases).items() if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", "").endswith("protocol.phases")}
    assert public - set(vars(phases)) == set()
    for name in ("init_voter_phase", "init_admin_phase_generate_keys", "init_admin_phase_generate_data",
                 "vote_phase", "tally_admin_phase", "tally_voter_phase"):
        assert getattr(phases, f"process_encrypted_input_mode_{name}") is getattr(phases, name)
