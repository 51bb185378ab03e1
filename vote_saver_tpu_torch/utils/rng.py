"""Seedable Fr randomness — the algebraic_random_device replacement.

The reference draws ElGamal/prover randomness from
``random::algebraic_random_device<Fr>`` (common.hpp:70,923-927,1131), which
is not seedable; SURVEY.md §2B calls for an injectable, reproducible source.
Deterministic tests seed it; production uses os.urandom.
"""

from __future__ import annotations

import hashlib
import os

from ..params import R


class FrRandom:
    """Deterministic (seeded) or OS-entropy stream of uniform Fr elements."""

    def __init__(self, seed: bytes | int | None = None):
        if seed is None:
            self._seeded = False
        else:
            self._seeded = True
            if isinstance(seed, int):
                seed = seed.to_bytes(32, "big")
            self._state = hashlib.sha256(b"vote_saver_tpu/rng" + seed).digest()
            self._counter = 0

    def __call__(self) -> int:
        # rejection-free: 512 bits mod R has bias < 2^-257
        if self._seeded:
            buf = b""
            for _ in range(2):
                buf += hashlib.sha256(self._state + self._counter.to_bytes(8, "big")).digest()
                self._counter += 1
            return int.from_bytes(buf, "big") % R
        return int.from_bytes(os.urandom(64), "big") % R

    def bits(self, n: int) -> list[int]:
        v = self()
        # fold extra draws in if more bits requested than one element carries
        out = []
        while len(out) < n:
            out.extend(int(b) for b in bin(self())[2:].zfill(254)[:254])
        return out[:n]
