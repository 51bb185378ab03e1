"""Executable state machines of the SaverAdmin / SaverVoter contracts.

Method-for-method port of the reference's TVM Solidity semantics
(voting_admin.sol / voting_voter.sol): same require codes, same chunked
uploads, same session lifecycle, the eid-equality + sn-uniqueness
double-vote rejection (voting_admin.sol:112-129), the uncommit/callback
state machine (voting_voter.sol:155-182) — with the TVM builtin
tvm.vergrth16 realised by chain.ballot_blob.vergrth16 over this framework's
verifier.  Serves as the in-memory chain simulator for e2e tests and the
normative behavioural spec for a future on-chain deployment.
"""

from __future__ import annotations

import dataclasses

from . import ballot_blob


class ChainError(Exception):
    """require(..., code) failure."""

    def __init__(self, code: int):
        super().__init__(f"require failed with code {code}")
        self.code = code


def require(cond: bool, code: int):
    if not cond:
        raise ChainError(code)


@dataclasses.dataclass
class SessionState:
    voters_number: int = 0
    pk_eid: bytes = b""
    vk_eid: bytes = b""
    voters_addresses: list = dataclasses.field(default_factory=list)
    voter_map_accepted: dict = dataclasses.field(default_factory=dict)
    rt: bytes = b""
    ct_sum: list = dataclasses.field(default_factory=list)
    m_sum: list = dataclasses.field(default_factory=list)
    dec_proof: list = dataclasses.field(default_factory=list)


class SaverAdmin:
    """voting_admin.sol:SaverAdmin."""

    def __init__(self, owner: str):
        require(owner != "", 101)
        self.owner = owner
        self.m_eid = b""
        self.m_crs_pk: list[bytes] = []
        self.m_crs_vk: list[bytes] = []
        self.m_session_state = SessionState()
        self.m_all_eid: set[bytes] = set()
        self.m_all_sn: set[bytes] = set()
        self.m_voter_msg_accepted = 0
        self.m_is_tally_committed = False
        self.m_is_session_initialized = False

    def _check_owner(self, sender: str):
        require(sender == self.owner, 103)

    def _check_not_initialized(self):
        require(not self.m_is_session_initialized, 105)

    # -- CRS upload (chunked, resumable: voting_admin.sol:33-47) ------------

    def update_crs_pk(self, sender: str, pk_chunk: bytes):
        self._check_owner(sender)
        self.reset_context(sender)
        self.m_crs_pk.append(pk_chunk)

    def update_crs_vk(self, sender: str, vk_chunk: bytes):
        self._check_owner(sender)
        self.reset_context(sender)
        self.m_crs_vk.append(vk_chunk)

    def reset_crs(self, sender: str):
        self._check_owner(sender)
        self.reset_context(sender)
        self.m_crs_pk = []
        self.m_crs_vk = []

    # -- session lifecycle (voting_admin.sol:53-106) ------------------------

    def reset_context(self, sender: str):
        self._check_owner(sender)
        self.m_is_tally_committed = False
        self.m_session_state = SessionState()
        self.m_eid = b""
        self.m_all_eid = set()
        self.m_all_sn = set()
        self.m_is_session_initialized = False

    def set_eid(self, sender: str, eid: bytes, pk_eid: bytes, vk_eid: bytes):
        self._check_owner(sender)
        self._check_not_initialized()
        require(eid not in self.m_all_eid, 107)  # eid replay rejection
        self.m_all_eid.add(eid)
        self.m_eid = eid
        self.m_session_state.pk_eid = pk_eid
        self.m_session_state.vk_eid = vk_eid

    def set_rt(self, sender: str, rt: bytes):
        self._check_owner(sender)
        self._check_not_initialized()
        self.m_session_state.rt = rt

    def add_voters(self, sender: str, voters_addresses: list[str]):
        self._check_owner(sender)
        self._check_not_initialized()
        for a in voters_addresses:
            self.m_session_state.voters_addresses.append(a)
            self.m_session_state.voter_map_accepted[a] = False
        self.m_session_state.voters_number += len(voters_addresses)

    def init_voting_session(self, sender: str):
        self._check_owner(sender)
        self._check_not_initialized()
        require(len(self.m_session_state.voters_addresses) > 0, 106)
        self.m_is_tally_committed = False
        self.m_is_session_initialized = True

    # -- ballot acceptance (voting_admin.sol:112-140) -----------------------

    def check_ballot(self, sender: str, eid: bytes, sn: bytes) -> int:
        require(sender in self.m_session_state.voter_map_accepted, 104)
        self.m_voter_msg_accepted = 1
        if eid != self.m_eid:
            self.m_session_state.voter_map_accepted[sender] = False
            return 1  # incorrect session id
        if sn in self.m_all_sn:
            self.m_session_state.voter_map_accepted[sender] = False
            return 2  # such sn already sent (double vote)
        self.m_all_sn.add(sn)
        self.m_session_state.voter_map_accepted[sender] = True
        return 0

    def uncommit_ballot(self, sender: str) -> int:
        require(sender in self.m_session_state.voter_map_accepted, 104)
        self.m_voter_msg_accepted = 2
        self.m_session_state.voter_map_accepted[sender] = False
        return 0

    # -- tally upload (chunked; voting_admin.sol:164-190) -------------------

    def reset_tally(self, sender: str):
        self._check_owner(sender)
        self.m_is_tally_committed = False
        self.m_session_state.ct_sum = []
        self.m_session_state.m_sum = []
        self.m_session_state.dec_proof = []

    def update_tally_ct_sum(self, sender: str, chunk: bytes):
        self._check_owner(sender)
        self.m_is_tally_committed = False
        self.m_session_state.ct_sum.append(chunk)

    def update_tally_m_sum(self, sender: str, chunk: bytes):
        self._check_owner(sender)
        self.m_is_tally_committed = False
        self.m_session_state.m_sum.append(chunk)

    def update_tally_dec_proof(self, sender: str, chunk: bytes):
        self._check_owner(sender)
        self.m_is_tally_committed = False
        self.m_session_state.dec_proof.append(chunk)

    def commit_tally(self, sender: str):
        self._check_owner(sender)
        self.m_is_tally_committed = True

    # -- getters (voting_admin.sol:196-260) ---------------------------------

    def get_crs_pk(self):
        return self.m_crs_pk

    def get_crs_vk(self):
        return self.m_crs_vk

    def get_voters_addresses(self):
        return self.m_session_state.voters_addresses

    def get_pk_eid(self):
        return self.m_session_state.pk_eid

    def get_vk_eid(self):
        return self.m_session_state.vk_eid

    def get_eid(self):
        return self.m_eid

    def get_rt(self):
        return self.m_session_state.rt

    def get_ct_sum(self):
        return self.m_session_state.ct_sum

    def get_m_sum(self):
        return self.m_session_state.m_sum

    def get_dec_proof(self):
        return self.m_session_state.dec_proof

    def get_voter_status(self, sender: str, voter_addr: str) -> bool:
        self._check_owner(sender)
        require(voter_addr in self.m_session_state.voter_map_accepted, 108)
        return self.m_session_state.voter_map_accepted[voter_addr]

    def get_is_tally_committed(self) -> bool:
        return self.m_is_tally_committed


class SaverVoter:
    """voting_voter.sol:SaverVoter."""

    def __init__(self, owner: str, admin: SaverAdmin, address: str):
        require(owner != "", 201)
        self.owner = owner
        self.address = address
        self.m_current_admin = admin
        self.m_pk = b""
        self.m_is_vote_accepted = False
        self.m_vi = b""
        self.m_sections: ballot_blob.BallotSections | None = None
        self.m_callback_status = -1

    def _check_owner(self, sender: str):
        require(sender == self.owner, 203)

    def update_admin(self, sender: str, new_admin: SaverAdmin):
        self._check_owner(sender)
        self.m_current_admin = new_admin
        self.m_is_vote_accepted = False

    def set_pk(self, sender: str, pk: bytes):
        self._check_owner(sender)
        self.m_pk = pk

    # -- ballot upload (chunked, voting_voter.sol:56-78) --------------------

    def reset_ballot(self, sender: str):
        self._check_owner(sender)
        self.m_vi = b""
        self.m_sections = None
        self.m_callback_status = -1
        self._on_uncommit(self.m_current_admin.uncommit_ballot(self.address))

    def update_ballot(self, sender: str, vi_chunk: bytes):
        self._check_owner(sender)
        self.m_vi += vi_chunk
        self.m_callback_status = -1
        self._on_uncommit(self.m_current_admin.uncommit_ballot(self.address))

    # -- commit: offsets + VERGRTH16 + admin callback (voting_voter.sol:84) -

    def commit_ballot(self, sender: str, proof_end: int, ct_begin: int, ct_end: int,
                      eid_begin: int, sn_begin: int, rt_begin: int):
        self._check_owner(sender)
        require(len(self.m_vi) > rt_begin, 207)
        require(rt_begin > sn_begin, 208)
        require(sn_begin > eid_begin, 209)
        require(eid_begin > ct_end, 210)  # STRICT, voting_voter.sol:91
        require(ct_end > ct_begin, 211)
        require(ct_begin > proof_end, 212)
        sec = ballot_blob.BallotSections(proof_end, ct_begin, ct_end, eid_begin, sn_begin, rt_begin)
        require(ballot_blob.vergrth16(self.m_vi, sec), 213)
        self.m_sections = sec
        self.m_callback_status = -1
        status = self.m_current_admin.check_ballot(
            self.address, self.m_vi[eid_begin:sn_begin], self.m_vi[sn_begin:rt_begin]
        )
        self._on_check(status)

    # -- getters (voting_voter.sol:111-139) ---------------------------------

    def get_pk(self):
        return self.m_pk

    def _slices(self):
        require(self.m_sections is not None, 207)
        return ballot_blob.split_vi(self.m_vi, self.m_sections)

    def get_proof(self):
        return self._slices()["proof"]

    def get_ct(self):
        return self._slices()["ct"]

    def get_eid(self):
        return self._slices()["eid"]

    def get_sn(self):
        return self._slices()["sn"]

    def get_rt(self):
        return self._slices()["rt"]

    def get_vi(self, sender: str):
        self._check_owner(sender)
        return self.m_vi

    def is_vote_accepted(self, sender: str) -> bool:
        self._check_owner(sender)
        return self.m_is_vote_accepted

    def get_callback_status(self, sender: str) -> int:
        self._check_owner(sender)
        return self.m_callback_status

    # -- admin callbacks (voting_voter.sol:155-182) -------------------------

    def _on_uncommit(self, result_status: int):
        if result_status == 0:
            self.m_is_vote_accepted = False
        self.m_callback_status = result_status

    def _on_check(self, result_status: int):
        self.m_is_vote_accepted = result_status == 0
        self.m_callback_status = result_status
