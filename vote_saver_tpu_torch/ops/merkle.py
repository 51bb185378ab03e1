"""Level-parallel Merkle tree over Pedersen digests.

Counterpart of ``vote_saver_tpu/ops/merkle.py``.  Two arms, chosen by the
caller's device:

  * on a device (the card by default, or "cpu" for the plain versions),
    each level is one ``pedersen_ops.pedersen_hash_bits`` call over all of
    its nodes, and the digests stay on the device until the tree is done;
  * ``device="host"``: each node through the ``refimpl.pedersen`` oracle,
    the arm the JAX package takes off the TPU.

Both give the same digests.  Layout as docs/WIRE_FORMATS.md: leaves are
voter public keys (255 bits), a level-0 digest is H(leaf), a parent
H(left ‖ right) (510 bits); the serialized tree is every digest, leaf
level first, root last.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import DIGEST_BITS, PUBLIC_KEY_BITS
from ..refimpl import pedersen as rpd
from . import limbs as lb
from . import pedersen_ops as po


def _hasher(device):
    """(rows, nbits) bits -> (rows, 255) digest bits: the oracle row by row
    for "host", else one Pedersen call on the device (the digests stay
    there)."""
    if device == "host":
        return lambda rows, nbits: np.array([rpd.pedersen_hash(list(map(int, r))) for r in rows], np.uint32)
    dev = lb.device_of(device)
    return lambda rows, nbits: po.pedersen_hash_bits(rows, nbits, dev)


def _host(level) -> np.ndarray:
    return np.asarray(level.cpu() if isinstance(level, torch.Tensor) else level, np.uint32)


def build_tree(leaf_bits: np.ndarray, device="cuda") -> list[np.ndarray]:
    """leaf_bits: (2^d, 255) 0/1 -> per-level digest arrays (uint32 bits),
    leaves first: [level0 (2^d, 255), ..., root (1, 255)]."""
    leaf_bits = np.asarray(leaf_bits)
    n = leaf_bits.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} leaves: a tree needs a power of two")
    hash_rows = _hasher(device)
    levels = [hash_rows(leaf_bits, PUBLIC_KEY_BITS)]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(hash_rows(cur.reshape(cur.shape[0] // 2, 2 * DIGEST_BITS), 2 * DIGEST_BITS))
    return [_host(lv) for lv in levels]


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


def verify_path(leaf_digest: np.ndarray, index: int, sibs: np.ndarray, root_bits: np.ndarray,
                device="cuda") -> bool:
    """Host-side path check (mirrors the in-circuit gadget): hash the leaf
    digest up its copath on `device` ("host": the oracle) and compare the
    result with the root."""
    hash_rows = _hasher(device)
    cur = np.asarray(leaf_digest)
    idx = index
    for s in np.asarray(sibs):
        pair = np.concatenate([s, cur] if idx & 1 else [cur, s])
        cur = _host(hash_rows(pair[None, :], 2 * DIGEST_BITS))[0]
        idx //= 2
    return bool(np.array_equal(cur, np.asarray(root_bits)))
