"""Batched Pedersen hashing on the device (the Merkle tree's hash).

Counterpart of ``vote_saver_tpu/ops/pedersen_ops.py``.  The window tables
are built once on the host from the ``refimpl`` oracle; hashing a batch of
messages is then one gather of a table point per (row, window) and a sum
over the windows with the complete Edwards addition (``EdwardsOps.add``:
its field multiplies are kernel K1), then one Fermat inversion for the
affine x-coordinate (K1's chain in one launch).  No sequential window walk,
no branches.

The JAX package sums the windows with a Hillis-Steele scan (about W log W
additions a row); here a halving tree adds the upper half of the windows
onto the lower half until one is left: W - 1 additions a row in
ceil(log2 W) rounds, the same sum (the addition is complete, so its order
does not matter).

Digest convention (docs/HASH_SPEC.md): 255 little-endian bits of the
x-coordinate of the Pedersen point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..circuit.gadgets import _window_constants
from ..params import DIGEST_BITS, PEDERSEN_WINDOW_BITS, R
from . import limbs as lb
from .curve_ops import jj_ops

# rows hashed per call of the sum: a row of W windows holds 4 W (L,) int32
# coordinates, and the plain add/sub carry passes work on int64 copies
# several times that size, so a level of a deeper tree runs in chunks
CHUNK_ROWS = 1 << 14

_tables: dict = {}


@functools.cache
def _host_tables(num_windows: int) -> tuple[np.ndarray, ...]:
    """(X, Y, Z, T) Montgomery limbs (num_windows, 8, L): per window w and
    3-bit digit d, the point enc(d) * 2^(4 local) * I_segment with enc(d) =
    (1 + s0 + 2 s1)(1 - 2 s2), as the JAX package's tables; the multiples
    1-4 of each window's base are the voting circuit's window constants,
    x negated for s2."""
    pts = []
    for mults in _window_constants(num_windows):
        for d in range(1 << PEDERSEN_WINDOW_BITS):
            x, y = mults[d & 3]
            pts.append(((R - x) % R, y) if d >> 2 else (x, y))
    coords = ([p[0] for p in pts], [p[1] for p in pts], [1] * len(pts), [p[0] * p[1] % R for p in pts])
    shape = (num_windows, 1 << PEDERSEN_WINDOW_BITS, lb.FR.num_limbs)
    return tuple(lb.ints_to_mont_limbs(c, lb.FR).reshape(shape) for c in coords)


def window_tables(num_windows: int, device="cuda") -> tuple[torch.Tensor, ...]:
    """The extended Edwards table points (X, Y, Z, T) as int32 tensors
    (num_windows, 8, L) on `device`, built once per window count and card."""
    dev = lb.device_of(device)
    key = (num_windows, dev)
    if key not in _tables:
        _tables[key] = tuple(lb.to_tensor(c, dev) for c in _host_tables(num_windows))
    return _tables[key]


def bits_to_digits(bits: torch.Tensor) -> torch.Tensor:
    """(rows, nbits) 0/1 -> (rows, ceil(nbits/3)) int64 3-bit window digits."""
    bits = bits.to(torch.int64)
    bits = F.pad(bits, (0, (-bits.shape[-1]) % PEDERSEN_WINDOW_BITS))
    b = bits.reshape(*bits.shape[:-1], -1, PEDERSEN_WINDOW_BITS)
    return b[..., 0] + 2 * b[..., 1] + 4 * b[..., 2]


def pedersen_point(digits: torch.Tensor, num_windows: int):
    """digits: (rows, W) on the tables' device -> the extended Edwards
    points (X, Y, Z, T), each (rows, L): the Pedersen sums."""
    jj = jj_ops()
    tables = window_tables(num_windows, digits.device)
    w = torch.arange(num_windows, device=digits.device)
    p = tuple(t[w, digits] for t in tables)  # (rows, W, L)
    n = num_windows
    while n > 1:
        h = n // 2
        s = jj.add(tuple(c[:, :h] for c in p), tuple(c[:, h : 2 * h] for c in p))
        p = tuple(torch.cat([a, c[:, 2 * h :]], dim=1) for a, c in zip(s, p)) if n % 2 else s
        n = h + n % 2
    return tuple(c[:, 0] for c in p)


def x_coord_bits(point) -> torch.Tensor:
    """Extended points (rows, L) -> (rows, 255) uint8 little-endian digest
    bits of the affine x-coordinate."""
    jj = jj_ops()
    ax, _ay = jj.to_affine(point)
    x = jj.f.from_mont(ax).to(torch.int64) & 0xFFFFFFFF  # (rows, L) plain limbs
    bits = (x[..., None] >> torch.arange(32, device=x.device)) & 1
    return bits.reshape(x.shape[0], -1)[:, :DIGEST_BITS].to(torch.uint8)


def pedersen_hash_bits(bits, nbits: int, device="cuda") -> torch.Tensor:
    """(rows, nbits) message bits (numpy or tensor) -> (rows, 255) uint8
    digest bits on `device`, CHUNK_ROWS rows at a time."""
    dev = lb.device_of(device)
    if not isinstance(bits, torch.Tensor):
        bits = lb.upload(np.asarray(bits, np.uint8), dev)
    bits = bits.to(dev)
    if bits.shape[-1] != nbits:
        raise ValueError(f"rows of {bits.shape[-1]} bits, expected {nbits}")
    num_windows = -(-nbits // PEDERSEN_WINDOW_BITS)
    digits = bits_to_digits(bits)
    return torch.cat([x_coord_bits(pedersen_point(digits[i : i + CHUNK_ROWS], num_windows))
                      for i in range(0, digits.shape[0], CHUNK_ROWS)])
