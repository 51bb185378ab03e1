"""Command-line frontend: the native-CLI replacement (L2).

Resurrects the reference's full (commented-out) flag surface
(bin/cli/src/main.cpp:499-547) as the real UX: --phase
{init_voter,init_admin,vote,vote_verify,tally_admin,tally_voter,all,bench},
--voter-idx, --vote, --tree-depth, --eid-bits, artifact path flags — plus
the active binary's behaviour (idempotent test-data generation + vote-phase
benchmark printing `Vote Phase Time_execution: <N>ms`, main.cpp:387-457).

Artifacts are .bin files in --workdir with the reference's naming scheme;
existing files are never overwritten (write_obj semantics, main.cpp:362-366),
making every phase resumable.

Counterpart of ``vote_saver_tpu/cli.py``, with the same phases, flags,
artifact names and write-once semantics, plus ``--device`` (default
``cuda``): admin setup, the Merkle tree and the vote phase run there
("cpu" runs the kernels' plain versions; "host" is the host-native arm of
admin setup and the Merkle oracle, for ``init_admin`` only).

Run: python -m vote_saver_tpu_torch.cli --phase all --tree-depth 6
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

from .params import DEFAULT_EID_BITS, DEFAULT_TREE_DEPTH, MSG_SIZE
from .protocol import marshal as M
from .protocol import phases
from .utils.rng import FrRandom


def log(*a):
    print(*a, flush=True)


class Workdir:
    def __init__(self, path: str):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)

    def file(self, name: str) -> pathlib.Path:
        return self.path / f"{name}.bin"

    def write(self, name: str, blob: bytes):
        p = self.file(name)
        if p.exists():
            log(f"File {p} exists and won't be overwritten.")
            return
        p.write_bytes(blob)

    def read(self, name: str) -> bytes:
        p = self.file(name)
        assert p.exists(), f"File {p} doesn't exist, make sure you created it!"
        return p.read_bytes()

    def exists(self, *names: str) -> bool:
        return all(self.file(n).exists() for n in names)


ADMIN_KEY_FILES = ["r1cs_proving_key", "r1cs_verification_key", "public_key", "secret_key", "verification_key"]
ADMIN_DATA_FILES = ["eid", "rt", "merkle_tree"]


def cmd_init_voter(wd: Workdir, args, rng):
    for i in args.voter_idx if args.voter_idx else range(1 << args.tree_depth):
        pk_blob, sk_blob = phases.init_voter_phase(i, rng)
        wd.write(f"voter_public_key{i}", pk_blob)
        wd.write(f"voter_secret_key{i}", sk_blob)
        log(f"Voter {i} keypair generated.")


def cmd_init_admin(wd: Workdir, args, rng):
    if not wd.exists(*ADMIN_KEY_FILES):
        log("Administrator generates R1CS and CRS...")
        blobs = phases.init_admin_phase_generate_keys(args.tree_depth, args.eid_bits, rng, args.device)
        for name, blob in zip(ADMIN_KEY_FILES, blobs):
            wd.write(name, blob)
        log("Administrator keys written.")
    pks = []
    for i in range(1 << args.tree_depth):
        p = wd.file(f"voter_public_key{i}")
        if p.exists():
            pks.append(p.read_bytes())
    log(f"Registering {len(pks)} voter public keys (zero-padded to {1 << args.tree_depth}).")
    eid_blob, rt_blob, tree_blob = phases.init_admin_phase_generate_data(
        args.tree_depth, args.eid_bits, pks, rng, args.device
    )
    for name, blob in zip(ADMIN_DATA_FILES, (eid_blob, rt_blob, tree_blob)):
        wd.write(name, blob)
    log("Election initialised (eid, rt, merkle_tree written).")


def cmd_vote(wd: Workdir, args, rng):
    indices = args.voter_idx or [0]
    votes = args.vote or [0]
    assert len(votes) == len(indices), "--vote count must match --voter-idx count"
    t0 = time.time()
    ballots = phases.vote_phase_batch(
        args.tree_depth, args.eid_bits, indices, votes,
        wd.read("merkle_tree"), wd.read("rt"), wd.read("eid"),
        [wd.read(f"voter_secret_key{i}") for i in indices],
        wd.read("public_key"), wd.read("r1cs_proving_key"),
        wd.read("r1cs_verification_key"), rng, args.device,
    )
    dt_ms = (time.time() - t0) * 1000
    log(f"Vote Phase Time_execution: {dt_ms:.0f}ms")
    for i, (proof_b, pinput_b, ct_b, sn_b) in zip(indices, ballots):
        wd.write(f"r1cs_proof{i}", proof_b)
        wd.write(f"r1cs_primary_input{i}", pinput_b)
        wd.write(f"cipher_text{i}", ct_b)
        wd.write(f"sn{i}", sn_b)
    log(f"{len(indices)} encrypted ballot(s) written.")


def cmd_vote_verify(wd: Workdir, args, rng):
    for i in args.voter_idx or [0]:
        ok = phases.verify_ballot(
            wd.read(f"r1cs_proof{i}"), wd.read(f"r1cs_primary_input{i}"),
            wd.read(f"cipher_text{i}"), wd.read("verification_key"),
            wd.read("r1cs_verification_key"),
        )
        log(f"Ballot {i} verification: {'true' if ok else 'false'}")
        if not ok:
            sys.exit(1)


def _collect_cts(wd: Workdir, depth: int) -> list[bytes]:
    cts = []
    for i in range(1 << depth):
        p = wd.file(f"cipher_text{i}")
        if p.exists():
            cts.append(p.read_bytes())
    assert cts, "no ciphertexts found"
    return cts


def cmd_tally_admin(wd: Workdir, args, rng):
    cts = _collect_cts(wd, args.tree_depth)
    log(f"Aggregating {len(cts)} encrypted ballots...")
    dec_proof, voting_res = phases.tally_admin_phase(
        args.tree_depth, cts, wd.read("secret_key"), wd.read("verification_key"),
        wd.read("r1cs_proving_key"), wd.read("r1cs_verification_key"),
    )
    wd.write("decryption_proof", dec_proof)
    wd.write("voting_result", voting_res)
    counts = M.de_scalar_vector_any(voting_res)
    log("Deciphered results of voting:")
    log(", ".join(str(c) for c in counts))


def cmd_tally_voter(wd: Workdir, args, rng):
    cts = _collect_cts(wd, args.tree_depth)
    ok = phases.tally_voter_phase(
        args.tree_depth, cts, wd.read("verification_key"),
        wd.read("r1cs_proving_key"), wd.read("r1cs_verification_key"),
        wd.read("voting_result"), wd.read("decryption_proof"),
    )
    counts = M.de_scalar_vector_any(wd.read("voting_result"))
    log("Results of voting:")
    log(", ".join(str(c) for c in counts))
    log(f"verification: {'true' if ok else 'false'}")
    if not ok:
        sys.exit(1)


def cmd_all(wd: Workdir, args, rng):
    n = 1 << args.tree_depth
    args.voter_idx = list(range(n))
    args.vote = args.vote or [i % MSG_SIZE for i in range(n)]
    cmd_init_voter(wd, args, rng)
    cmd_init_admin(wd, args, rng)
    cmd_vote(wd, args, rng)
    cmd_vote_verify(wd, args, rng)
    cmd_tally_admin(wd, args, rng)
    cmd_tally_voter(wd, args, rng)


def cmd_bench(wd: Workdir, args, rng):
    """The reference binary's active behaviour: generate test data if
    missing, then time one vote phase (main.cpp:429-492)."""
    if not wd.exists(*ADMIN_KEY_FILES, *ADMIN_DATA_FILES):
        args.voter_idx = list(range(1 << args.tree_depth))
        cmd_init_voter(wd, args, rng)
        cmd_init_admin(wd, args, rng)
    args.voter_idx, args.vote = [0], [1]
    cmd_vote(wd, args, rng)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="vote_saver_tpu_torch", description="SAVER voting protocol CLI (PyTorch + CUDA)"
    )
    p.add_argument(
        "--phase",
        choices=["init_voter", "init_admin", "vote", "vote_verify",
                 "tally_admin", "tally_voter", "all", "bench"],
        default="bench",
    )
    p.add_argument("--tree-depth", type=int, default=DEFAULT_TREE_DEPTH)
    p.add_argument("--eid-bits", type=int, default=DEFAULT_EID_BITS)
    p.add_argument("--voter-idx", type=int, nargs="*", default=None)
    p.add_argument("--vote", type=int, nargs="*", default=None)
    p.add_argument("--workdir", default="vote_saver_artifacts")
    p.add_argument("--seed", type=int, default=None, help="deterministic randomness (tests only)")
    p.add_argument("--device", default="cuda", help="cuda (default), cpu, or host (init_admin only)")
    args = p.parse_args(argv)

    wd = Workdir(args.workdir)
    rng = FrRandom(args.seed) if args.seed is not None else FrRandom()
    {
        "init_voter": cmd_init_voter,
        "init_admin": cmd_init_admin,
        "vote": cmd_vote,
        "vote_verify": cmd_vote_verify,
        "tally_admin": cmd_tally_admin,
        "tally_voter": cmd_tally_voter,
        "all": cmd_all,
        "bench": cmd_bench,
    }[args.phase](wd, args, rng)


if __name__ == "__main__":
    main()
