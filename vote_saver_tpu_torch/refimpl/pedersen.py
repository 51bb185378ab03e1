"""Reference Pedersen hash over JubJub + SHA-256 group hash (segment generators).

Mirrors the *role* of crypto3's
``pedersen<jubjub, sha2<256>, find_group_hash_default_params>`` (reference
common.hpp:150-155): a windowed Pedersen hash over the embedded Edwards curve
whose segment generators are derived by hashing a domain tag with SHA-256.
The exact derivation is this repo's own spec (docs/HASH_SPEC.md) since the
crypto3 sources are not vendored in the reference repo; what the protocol
requires is only that the in-circuit gadget, the batched device kernel and
this oracle agree bit-for-bit — which the tests enforce.

Hash definition (Sapling-style, 3-bit signed windows):
  * message = little-endian bit list, zero-padded to a multiple of 3;
  * window (s0, s1, s2) encodes digit = (1 + s0 + 2*s1) * (1 - 2*s2);
  * segment j covers 63 windows; window w contributes digit * 2^(4w) * I_j;
  * result point = sum_j (sum_w digit_{j,w} 2^(4w)) * I_j;
  * digest = 255 little-endian bits of the x-coordinate.
"""

from __future__ import annotations

import functools
import hashlib

from ..params import (
    R,
    JUBJUB_D,
    JUBJUB_RS,
    JUBJUB_COFACTOR,
    DIGEST_BITS,
    GROUP_HASH_TAG,
    PEDERSEN_WINDOW_BITS,
    PEDERSEN_WINDOWS_PER_SEGMENT,
    PEDERSEN_SPACING_BITS,
)
from . import curves as c
from .field import fr_sqrt


def _point_from_y(y: int, sign_bit: int):
    """Recover (x, y) on JubJub from y and the parity bit of x; None if off-curve."""
    # a x^2 + y^2 = 1 + d x^2 y^2, a = -1  =>  x^2 = (y^2 - 1) / (d y^2 + 1)
    num = (y * y - 1) % R
    den = (JUBJUB_D * y % R * y + 1) % R
    x2 = num * pow(den, R - 2, R) % R
    x = fr_sqrt(x2)
    if x is None:
        return None
    if x & 1 != sign_bit:
        x = (R - x) % R
    return (x, y)


def group_hash(tag: bytes, index: int):
    """Derive a prime-order JubJub point from (tag, index); SHA-256 based."""
    for counter in range(256):
        h = hashlib.sha256(
            tag + index.to_bytes(4, "big") + counter.to_bytes(4, "big")
        ).digest()
        y = int.from_bytes(h, "big")
        sign_bit = y >> 255 & 1
        y %= R
        p = _point_from_y(y, sign_bit)
        if p is None:
            continue
        p = c.jj_mul(p, JUBJUB_COFACTOR)  # clear cofactor
        if p == c.JJ_IDENTITY:
            continue
        assert c.jj_mul(p, JUBJUB_RS) == c.JJ_IDENTITY
        return p
    raise RuntimeError("group_hash failed to find a point")


@functools.cache
def segment_generator(j: int):
    return group_hash(GROUP_HASH_TAG, j)


def window_digit(s0: int, s1: int, s2: int) -> int:
    return (1 + s0 + 2 * s1) * (1 - 2 * s2)


def pedersen_point(bits) -> tuple:
    """Pedersen hash of a little-endian bit list; returns the JubJub point."""
    bits = list(bits)
    assert len(bits) > 0
    while len(bits) % PEDERSEN_WINDOW_BITS:
        bits.append(0)
    n_windows = len(bits) // PEDERSEN_WINDOW_BITS
    acc = c.JJ_IDENTITY
    for j in range(0, n_windows, PEDERSEN_WINDOWS_PER_SEGMENT):
        seg_windows = range(j, min(j + PEDERSEN_WINDOWS_PER_SEGMENT, n_windows))
        k = 0
        for local_w, w in enumerate(seg_windows):
            s0, s1, s2 = bits[3 * w], bits[3 * w + 1], bits[3 * w + 2]
            k += window_digit(s0, s1, s2) << (PEDERSEN_SPACING_BITS * local_w)
        seg = c.jj_mul(segment_generator(j // PEDERSEN_WINDOWS_PER_SEGMENT), k)
        acc = c.jj_add(acc, seg)
    return acc


def int_to_le_bits(x: int, n: int) -> list[int]:
    return [(x >> i) & 1 for i in range(n)]


def le_bits_to_int(bits) -> int:
    return sum(int(b) << i for i, b in enumerate(bits))


def pedersen_hash(bits) -> list[int]:
    """Pedersen digest = 255 little-endian bits of the result x-coordinate."""
    x, _ = pedersen_point(bits)
    return int_to_le_bits(x, DIGEST_BITS)
