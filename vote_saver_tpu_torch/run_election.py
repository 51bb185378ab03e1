"""A whole election through the in-memory chain: keys, the contracts, the
voters' ballots, the tally and the observer's check.

Counterpart of ``scripts/run_election.py`` over the port's SDK
(``sdk.py``), contracts (``chain/contracts.py``) and ballot blobs
(``chain/ballot_blob.py``), on the card by default.  Every artifact flows
through the contract surface as there: the CRS uploaded in chunks of
CHUNK bytes (30,000 hex characters a tonos-cli message), ``set_eid`` /
``set_rt``, each voter's ``vi`` blob uploaded in chunks and committed
(``commit_ballot``: offsets, VERGRTH16, the double-vote check), the tally
uploaded in chunks and committed, its counts decoded and the observer's
``verify_tally``.  A rejected ballot, a count that differs from the votes
or a tally that fails its check raises.  On ``device="cpu"`` the kernels'
plain versions run, but setup takes its host-native arm (the same keys),
as in ``scale.py``: the plain window sums take hours on the CPU.

    python -m vote_saver_tpu_torch.run_election --tree-depth 2 --voters 3 [--seed 11] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from . import sdk
from .chain import ballot_blob as bb
from .chain.contracts import SaverAdmin, SaverVoter
from .ops import limbs as lb
from .params import MSG_SIZE
from .protocol import marshal as M
from .utils.rng import FrRandom

CHUNK = 15000  # 30000 hex chars per tonos-cli message (the reference notebook's cell 7)


def log(msg: str) -> None:
    print(msg, flush=True)


def _vi(ballot, keys, eid_bits):
    pinput = M.de_scalar_vector(ballot.primary_input)
    sn_bits = M.unpack_field_elements_to_bits(pinput[1:3], 255)
    rt_bits = M.unpack_field_elements_to_bits(pinput[3:5], 255)
    return bb.build_vi(ballot.proof, keys.r1cs_verification_key, keys.public_key, ballot.ct, eid_bits, sn_bits,
                       rt_bits, vk_eid_blob=keys.verification_key)


def run(tree_depth: int = 2, voters: int = 3, seed: int | None = None, device="cuda") -> dict:
    """The election, as ``scripts/run_election.py`` runs it (voter i votes
    i % MSG_SIZE), on `device`.  Returns the counts, each voter's callback
    status, the observer's verdict and the seconds of each step."""
    dev = lb.device_of(device)
    rng = FrRandom(seed) if seed is not None else FrRandom()
    times = {}
    t0 = t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        times[name] = now - t
        t = now

    log(f"== setup: depth {tree_depth}, {voters} voters ==")
    keypairs = [sdk.generate_voter_keypair(rng) for _ in range(voters)]
    keys = sdk.admin_keygen(tree_depth, rng=rng, device=dev if dev.type == "cuda" else "host")
    election = sdk.init_election([k.public_key for k in keypairs], tree_depth, rng=rng, device=dev)
    lap("setup")
    log(f"   keys + election ready ({times['setup']:.1f} s)")

    log("== chain: deploy + CRS upload (chunked) ==")
    admin = SaverAdmin(owner="admin")
    for off in range(0, len(keys.r1cs_proving_key), CHUNK):
        admin.update_crs_pk("admin", keys.r1cs_proving_key[off : off + CHUNK])
    admin.update_crs_vk("admin", keys.r1cs_verification_key)
    log(f"   CRS uploaded in {len(admin.get_crs_pk())} chunks")

    log("== ballots (batched prove) ==")
    votes = [i % MSG_SIZE for i in range(voters)]
    ballots = sdk.generate_votes(keys, election, list(range(voters)), votes, [k.secret_key for k in keypairs],
                                 tree_depth, rng=rng, device=dev)
    lap("ballots")

    pinput0 = M.de_scalar_vector(ballots[0].primary_input)
    eid_bits = M.unpack_field_elements_to_bits(pinput0[:1], 64)
    vi0, sec0 = _vi(ballots[0], keys, eid_bits)
    admin.set_eid("admin", vi0[sec0.eid_begin : sec0.sn_begin], keys.public_key, keys.verification_key)
    admin.set_rt("admin", election.rt)
    chain_voters = [SaverVoter(f"v{i}", admin, f"addr{i}") for i in range(voters)]
    admin.add_voters("admin", [v.address for v in chain_voters])
    admin.init_voting_session("admin")

    log("== on-chain acceptance: upload + commit + VERGRTH16 ==")
    status = []
    for i, (ballot, voter) in enumerate(zip(ballots, chain_voters)):
        vi, sec = _vi(ballot, keys, eid_bits)
        for off in range(0, len(vi), CHUNK):
            voter.update_ballot(f"v{i}", vi[off : off + CHUNK])
        voter.commit_ballot(f"v{i}", sec.proof_end, sec.ct_begin, sec.ct_end, sec.eid_begin, sec.sn_begin,
                            sec.rt_begin)
        status.append(voter.get_callback_status(f"v{i}"))
        accepted = voter.is_vote_accepted(f"v{i}")
        log(f"   voter {i}: accepted={accepted} (status {status[-1]})")
        if status[-1] != 0 or not accepted:
            raise RuntimeError(f"voter {i}'s ballot was rejected (status {status[-1]})")
    lap("commit")

    log("== tally ==")
    cts = [b.ct for b in ballots]
    dec_proof, voting_res = sdk.tally_votes(keys, cts, tree_depth)
    for off in range(0, len(voting_res), CHUNK):
        admin.update_tally_m_sum("admin", voting_res[off : off + CHUNK])
    for off in range(0, len(dec_proof), CHUNK):
        admin.update_tally_dec_proof("admin", dec_proof[off : off + CHUNK])
    admin.commit_tally("admin")
    counts = sdk.decode_result(b"".join(admin.get_m_sum()))
    log(f"   counts: { {i: c for i, c in enumerate(counts) if c} }")
    if counts != [votes.count(c) for c in range(MSG_SIZE)]:
        raise RuntimeError(f"the tally's counts {counts} differ from the votes")
    ok = sdk.verify_tally(keys, cts, voting_res, dec_proof, tree_depth)
    log(f"   observer verification: {ok}")
    if not ok:
        raise RuntimeError("the observer rejected the tally")
    lap("tally")
    times["total"] = time.perf_counter() - t0
    log(f"== done in {times['total']:.1f} s ==")
    return dict(counts=counts, status=status, verified=ok, times_s=times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree-depth", type=int, default=2)
    ap.add_argument("--voters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help='"cuda" (the default) or "cpu" (the plain versions)')
    args = ap.parse_args(argv)
    run(args.tree_depth, args.voters, args.seed, args.device)


if __name__ == "__main__":
    main()
