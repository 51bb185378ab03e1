"""The port's entry points (SDK, JSON service, CLI) and its chain-layer
copies, against the JAX package's on the depth-2 election.

Mirrors ``tests/test_sdk_service.py``, ``test_cli.py`` and the cheap cases
of ``test_chain.py``: the SDK and ``service.handle`` give the JAX package's
blobs and responses (keypairs, election data, tally, decoding,
verification), the two CLIs write byte-identical ``init_voter`` and
``tally_admin`` artifacts, the CLI keeps its write-once, missing-file and
count-mismatch behaviour, and the chain copies' ``vergrth16`` runs the
port's verifiers.  Everything runs on the CPU (``device="cpu"``: the
kernels' plain versions).  The one vote, B = 1 through the service, takes
``test_torch_stream.py``'s host stand-ins for the five MSMs and the ballot
tail.
"""

import base64

import pytest

from vote_saver_tpu import cli as jcli
from vote_saver_tpu import sdk as jsdk
from vote_saver_tpu.chain import ballot_blob as jbb
from vote_saver_tpu.chain import tonos as jtonos
from vote_saver_tpu.frontends import service as jservice
from vote_saver_tpu_torch import cli, sdk
from vote_saver_tpu_torch.chain import ballot_blob as bb
from vote_saver_tpu_torch.chain import tonos
from vote_saver_tpu_torch.chain.contracts import ChainError, SaverAdmin, SaverVoter
from vote_saver_tpu_torch.frontends import service
from vote_saver_tpu_torch.protocol import ballot_dev, groth16
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.testing import torch_threads
from vote_saver_tpu_torch.utils.rng import FrRandom

from test_torch_stream import _host_tail
from test_torch_vote import _host_msms

KEY_NAMES = ("r1cs_proving_key", "r1cs_verification_key", "public_key", "secret_key", "verification_key")


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    with torch_threads(4):
        yield


def _keys(e) -> sdk.AdminKeys:
    return sdk.AdminKeys(e["pk_crs"], e["vk_crs"], e["pk_eid"], e["sk_eid"], e["vk_eid"])


def _b64(b: bytes) -> dict:
    return {"b64": base64.b64encode(b).decode()}


def _wire_keys(e) -> dict:
    return {k: _b64(e[f]) for k, f in zip(KEY_NAMES, ("pk_crs", "vk_crs", "pk_eid", "sk_eid", "vk_eid"))}


def test_sdk_matches_jax_on_the_election(election):
    e = election
    keys, jkeys = _keys(e), jsdk.AdminKeys(e["pk_crs"], e["vk_crs"], e["pk_eid"], e["sk_eid"], e["vk_eid"])
    ballots = [sdk.Ballot(*b) for b in e["ballots"]]
    assert all(sdk.verify_vote(keys, b) for b in ballots)
    cts = [b.ct for b in ballots]
    dec_proof, voting_res = sdk.tally_votes(keys, cts, tree_depth=2)
    assert (dec_proof, voting_res) == jsdk.tally_votes(jkeys, cts, tree_depth=2)
    counts = sdk.decode_result(voting_res)
    assert counts == jsdk.decode_result(voting_res) and counts[5] == 2 and counts[17] == 1
    assert sdk.verify_tally(keys, cts, voting_res, dec_proof, tree_depth=2)
    assert not sdk.verify_tally(keys, cts, M.ser_scalar_vector([c + (i == 5) for i, c in enumerate(counts)]),
                                dec_proof, tree_depth=2)


def test_sdk_keypair_and_election_match_jax():
    kp = sdk.generate_voter_keypair(FrRandom(4))
    assert kp == sdk.VoterKeypair(**vars(jsdk.generate_voter_keypair(FrRandom(4))))
    pks = [sdk.generate_voter_keypair(FrRandom(40 + i)).public_key for i in range(3)]
    ours = sdk.init_election(pks, tree_depth=2, rng=FrRandom(9), device="cpu")
    theirs = jsdk.init_election(pks, tree_depth=2, rng=FrRandom(9))
    assert (ours.eid, ours.rt, ours.merkle_tree) == (theirs.eid, theirs.rt, theirs.merkle_tree)


def test_service_responses_match_jax(election):
    """One request of each host and tree method through both services'
    handle: the same responses (blobs base64-encoded)."""
    e = election
    cts = [_b64(b[2]) for b in e["ballots"]]
    ballot = dict(zip(("proof", "primary_input", "ct", "sn"), map(_b64, e["ballots"][0])))
    requests = [
        {"method": "generate_voter_keypair", "params": {"seed": 9}},
        {"method": "init_election", "params": {"public_keys": [_b64(v[0]) for v in e["voters"]],
                                               "tree_depth": 2, "seed": 11}},
        {"method": "verify_vote", "params": {"keys": _wire_keys(e), "ballot": ballot}},
        {"method": "tally_votes", "params": {"keys": _wire_keys(e), "cts": cts, "tree_depth": 2}},
    ]
    for req in requests:
        assert service.handle(req, device="cpu") == jservice.handle(req), req["method"]
    tally = service.handle(requests[-1], device="cpu")
    for req in ({"method": "verify_tally", "params": {"keys": _wire_keys(e), "cts": cts, "tree_depth": 2,
                                                       "voting_res": tally["voting_res"],
                                                       "dec_proof": tally["dec_proof"]}},
                {"method": "decode_result", "params": {"voting_res": tally["voting_res"]}}):
        assert service.handle(req, device="cpu") == jservice.handle(req), req["method"]
    assert service.handle(req, device="cpu")["counts"][5] == 2
    with pytest.raises(ValueError, match="unknown method"):
        service.handle({"method": "nope", "params": {}}, device="cpu")


def test_service_generates_a_verified_ballot(election, monkeypatch):
    """generate_vote with B = 1 through the service on the CPU (host MSM
    and tail stand-ins): a ballot of the reference's wire shapes that both
    packages' verifiers accept."""
    monkeypatch.setattr(groth16, "prove_msms", _host_msms)
    monkeypatch.setattr(ballot_dev, "finalize_ballots_device", _host_tail)
    e = election
    req = {"method": "generate_vote", "params": {
        "keys": _wire_keys(e), "election": {"eid": _b64(e["eid"]), "rt": _b64(e["rt"]), "merkle_tree": _b64(e["tree"])},
        "voter_idx": 1, "vote": 7, "secret_key": _b64(e["voters"][1][1]), "tree_depth": 2, "seed": 5}}
    resp = service.handle(req, device="cpu")
    ballot = {k: base64.b64decode(v["b64"]) for k, v in resp.items()}
    assert [len(ballot[k]) for k in ("proof", "ct")] == [len(e["ballots"][0][0]), len(e["ballots"][0][2])]
    assert sdk.verify_vote(_keys(e), sdk.Ballot(**ballot))
    assert jsdk.verify_vote(jsdk.AdminKeys(e["pk_crs"], e["vk_crs"], e["pk_eid"], e["sk_eid"], e["vk_eid"]),
                            jsdk.Ballot(**ballot))
    assert service.handle({"method": "verify_vote", "params": {"keys": _wire_keys(e), "ballot": resp}},
                          device="cpu") == {"ok": True}


def test_cli_init_voter_matches_jax(tmp_path):
    args = ["--phase", "init_voter", "--tree-depth", "2", "--seed", "3"]
    cli.main(args + ["--workdir", str(tmp_path / "port")])
    jcli.main(args + ["--workdir", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 8 and sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert all((tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes() for n in names)


def test_cli_init_voter_is_write_once(tmp_path):
    cli.main(["--phase", "init_voter", "--tree-depth", "1", "--seed", "3", "--workdir", str(tmp_path)])
    pk0 = (tmp_path / "voter_public_key0.bin").read_bytes()
    assert len(pk0) == 32
    cli.main(["--phase", "init_voter", "--tree-depth", "1", "--seed", "4", "--workdir", str(tmp_path)])
    assert (tmp_path / "voter_public_key0.bin").read_bytes() == pk0


def test_cli_missing_artifacts_fail_cleanly(tmp_path):
    with pytest.raises(AssertionError, match="doesn't exist"):
        cli.main(["--phase", "vote", "--workdir", str(tmp_path)])
    with pytest.raises(AssertionError, match="no ciphertexts"):
        cli.main(["--phase", "tally_admin", "--workdir", str(tmp_path)])


def test_cli_vote_count_mismatch_rejected(tmp_path):
    with pytest.raises(AssertionError, match="--vote count"):
        cli.main(["--phase", "vote", "--voter-idx", "0", "1", "--vote", "2", "--workdir", str(tmp_path)])


def test_cli_tally_matches_jax(tmp_path, election, capsys):
    """tally_admin over the election's ciphertexts writes the JAX CLI's
    decryption proof and result byte for byte; tally_voter verifies them."""
    e = election
    files = dict(zip(KEY_NAMES, (e["pk_crs"], e["vk_crs"], e["pk_eid"], e["sk_eid"], e["vk_eid"])))
    files.update({f"cipher_text{i}": b[2] for i, b in enumerate(e["ballots"])})
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        for name, blob in files.items():
            (tmp_path / side / f"{name}.bin").write_bytes(blob)
    args = ["--phase", "tally_admin", "--tree-depth", "2"]
    cli.main(args + ["--workdir", str(tmp_path / "port")])
    jcli.main(args + ["--workdir", str(tmp_path / "jax")])
    for name in ("decryption_proof.bin", "voting_result.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    capsys.readouterr()
    cli.main(["--phase", "tally_voter", "--tree-depth", "2", "--workdir", str(tmp_path / "port")])
    assert "verification: true" in capsys.readouterr().out


def _make_vi(e, i, blob=bb):
    proof_b, pinput_b, ct_b, _ = e["ballots"][i]
    pinput = M.de_scalar_vector(pinput_b)
    bits = [M.unpack_field_elements_to_bits(pinput[a:b], n) for a, b, n in ((0, 1, 64), (1, 3, 255), (3, 5, 255))]
    return blob.build_vi(proof_b, e["vk_crs"], e["pk_eid"], ct_b, *bits, vk_eid_blob=e["vk_eid"])


def test_chain_vergrth16_accepts_the_ballot_and_rejects_a_corrupted_one(election):
    vi, sec = _make_vi(election, 0)
    jvi, jsec = _make_vi(election, 0, jbb)
    assert vi == jvi and vars(sec) == vars(jsec)
    assert bb.vergrth16(vi, sec) is True
    bad = bytearray(vi)
    bad[5] ^= 0xFF
    assert bb.vergrth16(bytes(bad), sec) is False


def test_chain_contracts_accept_one_ballot_and_reject_its_replay(election):
    e = election
    admin = SaverAdmin(owner="admin_key")
    admin.update_crs_pk("admin_key", e["pk_crs"])
    admin.update_crs_vk("admin_key", e["vk_crs"])
    vi, sec = _make_vi(e, 0)
    admin.set_eid("admin_key", vi[sec.eid_begin : sec.sn_begin], e["pk_eid"], e["vk_eid"])
    admin.set_rt("admin_key", e["rt"])
    voters = [SaverVoter(f"voter{i}_key", admin, f"voter{i}_addr") for i in range(2)]
    admin.add_voters("admin_key", [v.address for v in voters])
    admin.init_voting_session("admin_key")
    offsets = (sec.proof_end, sec.ct_begin, sec.ct_end, sec.eid_begin, sec.sn_begin, sec.rt_begin)
    for k, v in enumerate(voters):
        v.update_ballot(f"voter{k}_key", vi)
        v.commit_ballot(f"voter{k}_key", *offsets)
    assert voters[0].is_vote_accepted("voter0_key") and voters[0].get_ct() == e["ballots"][0][2]
    assert not voters[1].is_vote_accepted("voter1_key")
    assert voters[1].get_callback_status("voter1_key") == 2  # sn already sent
    with pytest.raises(ChainError) as err:
        voters[1].commit_ballot("voter1_key", 10, 5, 20, 30, 40, 50)
    assert err.value.code == 212


def test_chain_plain_mode_runs_the_ports_groth16_verify(election):
    e = election
    proof_b, pinput_b, _ct, _sn = e["ballots"][0]
    pinput = M.de_scalar_vector(pinput_b)
    bits = [M.unpack_field_elements_to_bits(pinput[a:b], n) for a, b, n in ((0, 1, 64), (1, 3, 255), (3, 5, 255))]
    for vote, ok in ((e["votes"][0], True), ((e["votes"][0] + 1) % 25, False)):
        m_field = [int(i == vote) for i in range(25)]
        assert bb.vergrth16(*bb.build_vi_plain(proof_b, e["vk_crs"], m_field, *bits)) is ok


def test_tonos_stream_matches_jax(election):
    e = election
    vi, sec = _make_vi(e, 0)

    def lines(mod):
        em = mod.TonosEmitter("0:adminaddr")
        em.deploy_admin()
        em.upload_crs(e["pk_crs"], e["vk_crs"])
        em.init_session(vi[sec.eid_begin : sec.sn_begin], e["pk_eid"], e["vk_eid"], e["rt"], ["0:v0"])
        em.upload_ballot("0:v0", "keys/v0.keys.json", vi, sec)
        return em.lines()

    assert lines(tonos) == lines(jtonos)
    assert tonos.admin_abi() == jtonos.admin_abi() and tonos.voter_abi() == jtonos.voter_abi()
