"""One typed protocol configuration feeding circuit synthesis and runtime.

The reference scatters its constants: compile-time policy members
(msg_size=25, arity=2 — common.hpp:157-165), a --tree-depth flag
(main.cpp:461-468) and eid_bits=64 re-hardcoded at every frontend
(main.cpp:389, ios.mm:59, wrapper.js:113).  SURVEY.md §5 calls for a single
config object — this is it.  Defaults reproduce the reference protocol.
"""

from __future__ import annotations

import dataclasses

from . import params


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    tree_depth: int = params.DEFAULT_TREE_DEPTH
    eid_bits: int = params.DEFAULT_EID_BITS
    msg_size: int = params.MSG_SIZE          # number of candidates
    secret_key_bits: int = params.SECRET_KEY_BITS
    digest_bits: int = params.DIGEST_BITS
    merkle_arity: int = params.MERKLE_ARITY
    chunk_size: int = params.CHUNK_SIZE      # packing chunk (field bits - 1)

    def __post_init__(self):
        assert 1 <= self.tree_depth <= 32
        assert 1 <= self.eid_bits <= self.chunk_size
        assert self.msg_size >= 1
        assert self.merkle_arity == 2, "only arity-2 trees are implemented"

    @property
    def num_voters(self) -> int:
        return 1 << self.tree_depth

    @property
    def primary_input_size(self) -> int:
        c = self.chunk_size
        packed = lambda bits: (bits + c - 1) // c
        return self.msg_size + packed(self.eid_bits) + 2 * packed(self.digest_bits)

    @property
    def ciphertext_points(self) -> int:
        return self.msg_size + 2


DEFAULT = ProtocolConfig()
