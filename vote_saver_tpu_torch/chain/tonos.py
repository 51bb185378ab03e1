"""tonos-cli command-stream emitter — the deployable face of the L4 layer.

The reference's orchestration notebook (bin/cli/src/protocol_exec.ipynb,
cells 4-35) turns phase artifacts into `tonos-cli` invocations against a TON
FLD cluster: genaddr/deploy for the two contracts, chunked `update_*` calls
capped at 30000 hex characters per message (cell 7), then the commit calls
carrying the ballot section offsets.  This module produces the same command
streams from this framework's artifacts, so a real cluster run needs only a
`tonos-cli` binary and the contract images — no Python on the signing host.

ABI descriptions for both contracts are emitted as `.abi.json` documents
generated from the simulator's method surface (chain/contracts.py), matching
the reference's shipped `voting_admin.abi.json` / `voting_voter.abi.json`
function lists (share/tvm/*.abi.json).  The `.tvc` images referenced by the
deploy commands compile from this framework's own contract sources
(chain/tvm/voting_admin.sol / voting_voter.sol, via chain/tvm/build.sh on a
TON-toolchain host).
"""

from __future__ import annotations

import json

from . import ballot_blob

HEX_CHUNK_CHARS = 30000  # notebook cell 7: max hex chars per message
CHUNK_BYTES = HEX_CHUNK_CHARS // 2


def _hex(b: bytes) -> str:
    return b.hex()


class TonosEmitter:
    """Builds a tonos-cli command list; `lines()` yields shell commands."""

    def __init__(
        self,
        admin_addr: str,
        admin_abi: str = "voting_admin.abi.json",
        voter_abi: str = "voting_voter.abi.json",
        admin_keys: str = "keys/voting_admin.keys.json",
    ):
        self.admin_addr = admin_addr
        self.admin_abi = admin_abi
        self.voter_abi = voter_abi
        self.admin_keys = admin_keys
        self.cmds: list[str] = []

    # -- generic ------------------------------------------------------------

    def call(self, addr: str, method: str, params: dict, abi: str, keys: str):
        self.cmds.append(
            f"tonos-cli call {addr} {method} '{json.dumps(params, separators=(',', ':'))}' "
            f"--abi {abi} --sign {keys}"
        )

    def admin_call(self, method: str, params: dict):
        self.call(self.admin_addr, method, params, self.admin_abi, self.admin_keys)

    def voter_call(self, addr: str, method: str, params: dict, keys: str):
        self.call(addr, method, params, self.voter_abi, keys)

    def _chunked(self, call, method: str, field: str, blob: bytes):
        for off in range(0, len(blob), CHUNK_BYTES):
            call(method, {field: _hex(blob[off : off + CHUNK_BYTES])})

    # -- deployment (notebook cells 2-5) -------------------------------------

    def genaddr(self, tvc: str, abi: str, keys: str):
        self.cmds.append(f"tonos-cli genaddr {tvc} {abi} --genkey {keys}")

    def deploy_admin(self, tvc: str = "voting_admin.tvc"):
        self.genaddr(tvc, self.admin_abi, self.admin_keys)
        self.cmds.append(
            f"tonos-cli deploy {tvc} '{{}}' --abi {self.admin_abi} --sign {self.admin_keys}"
        )

    def deploy_voter(self, voter_addr: str, pk_hex: str, keys: str,
                     tvc: str = "voting_voter.tvc"):
        self.genaddr(tvc, self.voter_abi, keys)
        params = {"admin": self.admin_addr, "pk": pk_hex}
        self.cmds.append(
            f"tonos-cli deploy {tvc} '{json.dumps(params, separators=(',', ':'))}' "
            f"--abi {self.voter_abi} --sign {keys}"
        )

    # -- admin session setup (notebook cells 11-17) ---------------------------

    def upload_crs(self, pk_crs: bytes, vk_crs: bytes):
        self._chunked(self.admin_call, "update_crs_pk", "pk_chunk", pk_crs)
        self._chunked(self.admin_call, "update_crs_vk", "vk_chunk", vk_crs)

    def init_session(self, eid: bytes, pk_eid: bytes, vk_eid: bytes, rt: bytes,
                     voter_addrs: list[str]):
        self.admin_call("set_eid", {
            "eid": _hex(eid), "pk_eid": _hex(pk_eid), "vk_eid": _hex(vk_eid),
        })
        self.admin_call("set_rt", {"rt": _hex(rt)})
        self.admin_call("add_voters", {"voters_addresses": voter_addrs})
        self.admin_call("init_voting_session", {})

    # -- ballot upload + commit (notebook cells 20-24; README.md:208-222) -----

    def upload_ballot(self, voter_addr: str, keys: str, vi: bytes,
                      sec: ballot_blob.BallotSections):
        for off in range(0, len(vi), CHUNK_BYTES):
            self.voter_call(voter_addr, "update_ballot",
                            {"vi": _hex(vi[off : off + CHUNK_BYTES])}, keys)
        self.voter_call(voter_addr, "commit_ballot", {
            "proof_end": sec.proof_end, "ct_begin": sec.ct_begin,
            "ct_end": sec.ct_end, "eid_begin": sec.eid_begin,
            "sn_begin": sec.sn_begin, "rt_begin": sec.rt_begin,
        }, keys)

    # -- tally (notebook cells 30-35) -----------------------------------------

    def upload_tally(self, ct_sum: bytes, m_sum: bytes, dec_proof: bytes):
        self._chunked(self.admin_call, "update_tally_ct_sum", "chunk", ct_sum)
        self._chunked(self.admin_call, "update_tally_m_sum", "chunk", m_sum)
        self._chunked(self.admin_call, "update_tally_dec_proof", "chunk", dec_proof)
        self.admin_call("commit_tally", {})

    # -- output ----------------------------------------------------------------

    def lines(self) -> list[str]:
        return list(self.cmds)

    def script(self) -> str:
        return "#!/bin/sh\nset -e\n" + "\n".join(self.cmds) + "\n"


# ---------------------------------------------------------------------------
# ABI documents (introspected from the simulator's method surface)
# ---------------------------------------------------------------------------

_ADMIN_FUNCTIONS = [
    ("update_crs_pk", [("pk_chunk", "bytes")], []),
    ("update_crs_vk", [("vk_chunk", "bytes")], []),
    ("reset_crs", [], []),
    ("reset_context", [], []),
    ("set_eid", [("eid", "bytes"), ("pk_eid", "bytes"), ("vk_eid", "bytes")], []),
    ("set_rt", [("rt", "bytes")], []),
    ("add_voters", [("voters_addresses", "address[]")], []),
    ("init_voting_session", [], []),
    ("check_ballot", [("eid", "bytes"), ("sn", "bytes")], [("value0", "uint32")]),
    ("uncommit_ballot", [], [("value0", "uint32")]),
    ("reset_tally", [], []),
    ("update_tally_ct_sum", [("chunk", "bytes")], []),
    ("update_tally_m_sum", [("chunk", "bytes")], []),
    ("update_tally_dec_proof", [("chunk", "bytes")], []),
    ("commit_tally", [], []),
    ("get_crs_pk", [], [("value0", "bytes")]),
    ("get_crs_vk", [], [("value0", "bytes")]),
    ("get_voters_addresses", [], [("value0", "address[]")]),
    ("get_pk_eid", [], [("value0", "bytes")]),
    ("get_vk_eid", [], [("value0", "bytes")]),
    ("get_eid", [], [("value0", "bytes")]),
    ("get_rt", [], [("value0", "bytes")]),
    ("get_ct_sum", [], [("value0", "bytes")]),
    ("get_m_sum", [], [("value0", "bytes")]),
    ("get_dec_proof", [], [("value0", "bytes")]),
    ("get_voter_status", [("voter_addr", "address")], [("value0", "bool")]),
    ("get_is_tally_committed", [], [("value0", "bool")]),
]

_VOTER_FUNCTIONS = [
    ("constructor", [("admin", "address"), ("pk", "bytes")], []),
    ("update_admin", [("new_admin", "address")], []),
    ("set_pk", [("pk", "bytes")], []),
    ("reset_ballot", [], []),
    ("update_ballot", [("vi", "bytes")], []),
    ("commit_ballot", [("proof_end", "uint32"), ("ct_begin", "uint32"),
                       ("ct_end", "uint32"), ("eid_begin", "uint32"),
                       ("sn_begin", "uint32"), ("rt_begin", "uint32")], []),
    ("get_pk", [], [("value0", "bytes")]),
    ("get_proof", [], [("value0", "bytes")]),
    ("get_ct", [], [("value0", "bytes")]),
    ("get_eid", [], [("value0", "bytes")]),
    ("get_sn", [], [("value0", "bytes")]),
    ("get_rt", [], [("value0", "bytes")]),
    ("get_vi", [], [("value0", "bytes")]),
    ("is_vote_accepted", [], [("value0", "bool")]),
    ("get_callback_status", [], [("value0", "int16")]),
    ("get_vi_len", [], [("value0", "uint256")]),
]


def _abi_doc(functions) -> dict:
    return {
        "ABI version": 2,
        "header": ["pubkey", "time", "expire"],
        "functions": [
            {
                "name": name,
                "inputs": [{"name": n, "type": t} for n, t in ins],
                "outputs": [{"name": n, "type": t} for n, t in outs],
            }
            for name, ins, outs in functions
        ],
        "data": [],
        "events": [],
    }


def admin_abi() -> dict:
    return _abi_doc(_ADMIN_FUNCTIONS)


def voter_abi() -> dict:
    return _abi_doc(_VOTER_FUNCTIONS)


def write_artifacts(outdir) -> list[str]:
    """Write the .abi.json documents; returns the paths written."""
    import pathlib

    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, doc in (("voting_admin.abi.json", admin_abi()),
                      ("voting_voter.abi.json", voter_abi())):
        p = out / name
        p.write_text(json.dumps(doc, indent=1))
        paths.append(str(p))
    return paths
