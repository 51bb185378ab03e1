"""Merkle tree over Pedersen digests, host arm.

Counterpart of ``vote_saver_tpu/ops/merkle.py`` (which imports jax): the
tree is built through the ``refimpl.pedersen`` oracle, the arm the JAX
package takes off the TPU; Pedersen on the device is a later slice.  Layout
as docs/WIRE_FORMATS.md: leaf level first, root last.
"""

from __future__ import annotations

import numpy as np

from ..params import DIGEST_BITS
from ..refimpl import pedersen as rpd


def _hash_rows(rows: np.ndarray) -> np.ndarray:
    return np.array([rpd.pedersen_hash(list(map(int, r))) for r in rows], np.uint32)


def build_tree(leaf_bits: np.ndarray) -> list[np.ndarray]:
    """leaf_bits: (2^d, 255) 0/1 -> per-level digest arrays, leaves first."""
    n = leaf_bits.shape[0]
    assert n & (n - 1) == 0 and n >= 1
    levels = [_hash_rows(np.asarray(leaf_bits))]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(_hash_rows(cur.reshape(cur.shape[0] // 2, 2 * DIGEST_BITS)))
    return levels


def root(levels: list[np.ndarray]) -> np.ndarray:
    return levels[-1][0]


def flatten_tree(levels: list[np.ndarray]) -> np.ndarray:
    """All node digests, leaf level first -> (2^(d+1)-1, 255)."""
    return np.concatenate(levels, axis=0)


def unflatten_tree(flat: np.ndarray, depth: int) -> list[np.ndarray]:
    levels, off = [], 0
    n = 1 << depth
    while n >= 1:
        levels.append(flat[off : off + n])
        off += n
        n //= 2
    assert off == flat.shape[0]
    return levels


def copath(levels: list[np.ndarray], index: int) -> np.ndarray:
    """Sibling digests bottom-up for the given leaf index -> (depth, 255)."""
    sibs = []
    idx = index
    for lvl in levels[:-1]:
        sibs.append(lvl[idx ^ 1])
        idx //= 2
    return np.stack(sibs, axis=0)
