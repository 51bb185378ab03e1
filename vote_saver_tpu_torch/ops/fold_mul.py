"""The matmul-fold Montgomery multiply: its plan and its plain PyTorch form.

Counterpart of ``vote_saver_tpu/ops/fold_mul.py`` (which imports jax): the
numpy part, ``plan()`` and ``_balanced256_host``, is carried here, and
``mul_fold_plain`` is the pipeline on torch tensors.  It is the plain
version of the ``fold`` multiplier mode of kernel K1 (``MulFold`` in
``csrc/mul_modes.cuh``):

  1. digits: each operand's 8-bit digits, four per 32-bit limb (the same
     digits as two per 16-bit limb in the JAX layout);
  2. product columns: column c = sum_{i+j=c} a_i b_j, each < 2^22;
  3. pieces: each column split into three 8-bit pieces;
  4. fold: one exact integer product (in float64, since every sum is
     < 2^24) against the constant matrix, whose row (c, t) holds the
     balanced base-256 digits of 2^(8(c+t)) * R^-1 * 2^32 mod N;
  5. a byte carry pass, then two Montgomery steps on 16-bit words that
     divide the 2^32 pre-scale back out, leaving a value < 2N;
  6. a conditional subtract.

The geometry is the JAX package's, checked by the tests against its
``plan()``: Fq 48 digits, 95 columns, a 285 x 52 matrix; Fr 32 digits, 63
columns, 189 x 36.  Montgomery R is 2^384 / 2^256 in both layouts, so the
result equals K1's in every mode, limb for limb.

Two CUDA forms run step 4: K1's per-lane ``dp4a`` loop over the matrix as
``packed_matrix`` lays it out, and the probes' tensor-core fold
(``csrc/fold_mma.cuh``), where a warp's 32 lanes are one tile of pieces
multiplied by the matrix as ``mma_operand`` lays it out; ``mul_fold_tile``
is that form's data flow in plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import FieldSpec

DIGIT_BITS = 8
PIECE_BITS = 8
WORD_BITS = 16  # the word of the two closing Montgomery steps
MMA_N, MMA_K = 8, 32  # the n and k of one mma.sync.m16n8k32 tile (int8)
TILE_LANES = 32  # a warp's lanes: the rows of one tensor-core fold tile


def _balanced256_host(v: int, nd: int) -> list[int]:
    """v >= 0 -> nd balanced base-256 digits in [-128, 127]."""
    digs = []
    carry = 0
    for _ in range(nd):
        t = (v & 255) + carry
        v >>= 8
        if t > 127:
            digs.append(t - 256)
            carry = 1
        else:
            digs.append(t)
            carry = 0
    assert carry == 0 and v == 0
    return digs


@functools.cache
def plan(spec: FieldSpec):
    """Static geometry + constant matrix for one field's fold pipeline.

    ``spec`` is the port's 32-bit layout; the plan is stated, as in the JAX
    package, over 16-bit words (``L`` 16-bit limbs, ``lb`` = 16)."""
    N = spec.modulus
    lb = WORD_BITS
    L = spec.num_limbs * spec.limb_bits // lb  # 16-bit words per element
    nd = 2 * L  # 8-bit digits per operand
    ncols = 2 * nd - 1  # product columns
    # column bound: <= nd * 255^2 < 2^22 -> 3 pieces of 8 bits
    npieces = 3
    # bytes of the folded value G < rows * 255 * 127 * N  (rows = ncols*npieces)
    rows = ncols * npieces
    gmax = rows * 255 * 128 * N
    nbytes = (gmax.bit_length() + 7) // 8 + 1
    pre_shift = 2 * lb  # cancelled by two word-steps
    rinv = pow(spec.mont_r, N - 2, N)
    mat = np.zeros((rows, nbytes), dtype=np.int8)
    for c in range(ncols):
        for t in range(npieces):
            w = (pow(2, DIGIT_BITS * (c + t) + pre_shift, N) * rinv) % N
            mat[c * npieces + t] = _balanced256_host(w, nbytes)
    # sanity: exactness of the fold's accumulation
    assert rows * 255 * 128 < (1 << 24)
    return dict(
        spec=spec, L=L, lb=lb, nd=nd, ncols=ncols, npieces=npieces,
        nbytes=nbytes, mat=mat,
        n_limbs=[(N >> (lb * k)) & ((1 << lb) - 1) for k in range(L)],
        n0_inv=(-pow(N, -1, 1 << lb)) % (1 << lb),
    )


def packed_matrix(spec: FieldSpec) -> np.ndarray:
    """The fold matrix as the CUDA fold reads it: rows padded to a multiple
    of 4, then (rows / 4, nbytes) int32 words whose byte k is the entry of
    row 4g + k (the layout of one ``dp4a``)."""
    mat = plan(spec)["mat"]
    rows = -(-mat.shape[0] // 4) * 4
    padded = np.zeros((rows, mat.shape[1]), np.int8)
    padded[: mat.shape[0]] = mat
    b = padded.view(np.uint8).reshape(rows // 4, 4, -1).astype(np.uint32)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return np.ascontiguousarray(words.view(np.int32))


def mma_operand(spec: FieldSpec) -> np.ndarray:
    """The fold matrix as the B operand of the tensor-core fold
    (``csrc/fold_mma.cuh``): (N, K) int8, N = nbytes rounded up to a
    multiple of 8 (one mma n8 tile per 8 output bytes), K = rows rounded up
    to a multiple of 32 (one k32 step per 32 pieces), K contiguous (the
    operand's "col" layout); entry [d, r] is the matrix entry of row r and
    output byte d, zero in the padding.  Fq: 56 x 288."""
    mat = plan(spec)["mat"]
    rows, nbytes = mat.shape
    out = np.zeros((-(-nbytes // MMA_N) * MMA_N, -(-rows // MMA_K) * MMA_K), np.int8)
    out[:nbytes, :rows] = mat.T
    return out


@functools.cache
def _consts(spec: FieldSpec, device: str):
    p = plan(spec)
    nd, ncols = p["nd"], p["ncols"]
    # (nd * nd, ncols) 0/1 matrix summing digit product (i, j) into column i + j
    ij = (torch.arange(nd)[:, None] + torch.arange(nd)[None, :]).flatten()
    diag = torch.zeros(nd * nd, ncols, dtype=torch.float64)
    diag[torch.arange(nd * nd), ij] = 1.0
    mat = torch.from_numpy(p["mat"].astype(np.float64))
    n16 = torch.tensor(p["n_limbs"], dtype=torch.int64)
    return diag.to(device), mat.to(device), n16.to(device)


def _digits(x: torch.Tensor) -> torch.Tensor:
    """int32 (..., L32) limbs -> int64 (..., 4 * L32) 8-bit digits."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 8, device=x.device)
    return ((v[..., None] >> shifts) & 255).flatten(-2)


def _columns(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Steps 1-2: (..., L) int32 limbs -> (..., ncols) int64 product columns."""
    diag, _mat, _n16 = _consts(spec, str(a.device))
    da, db = _digits(a), _digits(b)
    # digit products < 2^16 and columns < 2^22: exact in float64
    prod = (da.to(torch.float64)[..., :, None] * db.to(torch.float64)[..., None, :]).flatten(-2)
    return (prod @ diag).to(torch.int64)


def _finish(spec: FieldSpec, g: torch.Tensor) -> torch.Tensor:
    """Steps 5-6: (..., nbytes) int64 signed byte coefficients of the folded
    value -> (..., L) int32 canonical limbs."""
    p = plan(spec)
    _diag, _mat, n16 = _consts(spec, str(g.device))
    # byte carry pass (signed -> canonical bytes; the value is nonnegative)
    outb = []
    carry = torch.zeros_like(g[..., 0])
    for d in range(p["nbytes"]):
        t = g[..., d] + carry
        outb.append(t & 255)
        carry = t >> 8
    nl = (p["nbytes"] + 1) // 2
    zero = torch.zeros_like(outb[0])
    limbs = [outb[2 * k] + ((outb[2 * k + 1] if 2 * k + 1 < p["nbytes"] else zero) << 8) for k in range(nl)]
    # two Montgomery word steps: divide out the 2^32 pre-scale
    lbits, mask, L = p["lb"], (1 << p["lb"]) - 1, p["L"]
    for _ in range(2):
        m = (limbs[0] * p["n0_inv"]) & mask
        c = (limbs[0] + m * n16[0]) >> lbits
        nxt = []
        for k in range(1, len(limbs)):
            t = limbs[k] + c
            if k < L:
                t = t + m * n16[k]
            nxt.append(t & mask)
            c = t >> lbits
        nxt.append(c)
        limbs = nxt
    rows = torch.stack(limbs[: L + 1], dim=-1)  # (..., L + 1) 16-bit words, value < 2N
    # conditional subtract
    n_ext = torch.cat([n16, n16.new_zeros(1)])
    borrow = torch.zeros_like(rows[..., 0])
    diff = []
    for k in range(L + 1):
        t = rows[..., k] - n_ext[k] - borrow
        diff.append(t & mask)
        borrow = (t >> lbits) & 1
    words = torch.where((borrow == 0)[..., None], torch.stack(diff, dim=-1), rows)[..., :L]
    v = words[..., 0::2] | (words[..., 1::2] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def mul_fold_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery a * b * R^-1 mod N through the fold pipeline; (..., L)
    int32 limbs in and out, canonical."""
    p = plan(spec)
    _diag, mat, _n16 = _consts(spec, str(a.device))
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    cols = _columns(spec, a, b)  # (..., ncols)
    shifts = torch.arange(0, PIECE_BITS * p["npieces"], PIECE_BITS, device=a.device)
    pieces = ((cols[..., None] >> shifts) & 255).flatten(-2)  # (..., rows), row = 3c + t
    # |g| < rows * 255 * 128 < 2^24: exact in float64, on the CPU and the card
    g = (pieces.reshape(-1, pieces.shape[-1]).to(torch.float64) @ mat).to(torch.int64)
    return _finish(spec, g.reshape(lead + (p["nbytes"],)))


def tile_pieces(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rows of the tensor-core fold's A tile, as ``csrc/fold_mma.cuh``
    stores them: (n, K) uint8 for (n, L) int32 limbs.  Column c is computed
    from 2^23, so its float32 bits are 0x4B000000 + c; four columns pack
    into three little-endian words by byte selection (the kernel's
    ``__byte_perm`` selectors 0x4210, 0x5421, 0x6542), a missing fourth
    column counting as 0; row byte 3c + t is piece t of column c, and the
    bytes past the last piece are 0."""
    p = plan(spec)
    cols = _columns(spec, a, b)
    n, ncols = cols.shape
    groups = -(-ncols // 4)
    bits = torch.zeros(n, 4 * groups, dtype=torch.int64, device=cols.device)
    bits[:, :ncols] = 0x4B000000 + cols  # the float32 bits of 2^23 + column
    v = bits.reshape(n, groups, 4)
    # (source word, byte) of each byte of the three words of a group of four columns
    sel = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2)]
    out = torch.stack([(v[..., w] >> (8 * k)) & 255 for w, k in sel], dim=-1).reshape(n, 12 * groups)
    k_pad = -(-p["mat"].shape[0] // MMA_K) * MMA_K
    assert 12 * groups == k_pad
    return out.to(torch.uint8)


def mul_fold_tile(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tensor-core fold's data flow in plain PyTorch, on the CPU: the
    (n, K) u8 pieces (``tile_pieces``), cut into tiles of TILE_LANES lanes
    (the last one padded with zero rows, as a ragged warp's spare threads
    add rows the kernel never stores), each (32, K) u8 tile times the
    (K, N) s8 ``mma_operand`` in int64, exact; the first nbytes columns of
    each lane's row are its coefficients, then ``_finish`` (steps 5-6).
    (n, L) int32 limbs in and out, canonical."""
    p = plan(spec)
    pieces = tile_pieces(spec, a, b).to(torch.int64)
    n = pieces.shape[0]
    tiles = -(-n // TILE_LANES)
    padded = torch.zeros(tiles * TILE_LANES, pieces.shape[1], dtype=torch.int64)
    padded[:n] = pieces
    bop = torch.from_numpy(mma_operand(spec).astype(np.int64)).T  # (K, N)
    acc = torch.stack([t @ bop for t in padded.reshape(tiles, TILE_LANES, -1)]).reshape(-1, bop.shape[1])
    return _finish(spec, acc[:n, : p["nbytes"]])
