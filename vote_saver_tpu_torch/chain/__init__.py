"""On-chain layer parity (L4): ballot blob building + contract state machines.

The reference's L4 is two TVM Solidity contracts (share/tvm/voting_admin.sol,
voting_voter.sol) driven through tonos-cli.  The TPU-native framework keeps
the chain-facing byte formats as host-side I/O (SURVEY.md §5) and provides:

  * ballot_blob — the chunked `vi` verifier-input blob (mode byte ‖ proof ‖
    vk ‖ pk_eid ‖ ct ‖ eid ‖ sn ‖ rt with bit-expanded trailing sections,
    README.md:117-135,219) and its VERGRTH16-equivalent verifier;
  * contracts — executable Python state machines with the contracts' exact
    method surface, require codes and callback flow (chunked uploads,
    session lifecycle, eid equality + sn-uniqueness double-vote rejection,
    tally commit), usable as an in-memory chain simulator in tests and as
    the normative spec for any future on-chain port.
"""
