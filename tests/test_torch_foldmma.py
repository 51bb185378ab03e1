"""The tensor-core fold of the probes K7 and K10 (``csrc/fold_mma.cuh``) on
the CPU, against the JAX package.

The kernel multiplies a warp's 32 lanes of byte pieces by the fold matrix
as ``mma.sync`` tiles: the pieces are the A operand, (32, K) unsigned bytes,
and ``fold_mul.mma_operand`` is the B operand, (N, K) signed bytes with K
contiguous.  Here: that B operand holds the JAX ``fold_mul.plan`` matrix
entry for entry with its padding zero; the A rows ``fold_mul.tile_pieces``
lays out (the kernel's byte packing of the 2^23-biased column bits) hold
the pieces of the JAX ``product_columns`` in the row order of the plan;
and ``fold_mul.mul_fold_tile``, the tile's data flow in plain PyTorch
((32, K) u8 x (K, N) s8 in int64, then the carry pass, the word steps and
the conditional subtract), equals ``fold_mul.mul_fold_plain``, the JAX
``mul_fold_spec`` and x y R^-1 mod N on seeded lanes led by saturated
digits, at a lane count that leaves the last tile ragged.  Exact equality
throughout.  The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

    python -m pytest tests/test_torch_foldmma.py -q -p no:cacheprovider
"""

import pathlib
import random
import sys

import numpy as np
import pytest
import torch

from test_torch_curve import env16  # noqa: F401
from vote_saver_tpu_torch.ops import fold_mul
from vote_saver_tpu_torch.ops import limbs as lb

SHAPES = {"fq": ((56, 288), (285, 52)), "fr": ((40, 192), (189, 36))}


def _jax_plan(spec):
    from vote_saver_tpu.ops import fold_mul as jfm
    from vote_saver_tpu.params import FieldSpec

    return jfm.plan(FieldSpec(spec.name, spec.modulus, 16, 2 * spec.num_limbs))


def _raw(vals, spec) -> torch.Tensor:
    """Values below 2^(32 L) as (n, L) int32 limbs, not reduced mod N."""
    words = [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(spec.num_limbs)] for v in vals]
    return torch.from_numpy(np.array(words, np.uint32).view(np.int32))


def _lanes(name: str, n: int, seed: int):
    """n raw values: saturated digits first (every digit 255, every other
    byte 255, N - 1, R mod N, 0, 1), then uniform below 2^(32 L) and below N."""
    spec = lb.spec_for(name)
    N, bits = spec.modulus, 32 * spec.num_limbs
    ones = (1 << bits) - 1
    alt = int.from_bytes(bytes([255, 0]) * (bits // 16), "little")
    rnd = random.Random(seed)
    xs = [ones, ones, alt, N - 1, spec.mont_r % N, 0, 1]
    ys = [ones, N - 1, alt, N - 1, ones, ones, 1]
    while len(xs) < n:
        xs.append(rnd.randrange(1 << bits) if len(xs) % 2 else rnd.randrange(N))
        ys.append(rnd.randrange(1 << bits) if len(ys) % 3 else rnd.randrange(N))
    return spec, xs, ys


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_mma_operand_matches_jax_plan(name):
    spec = lb.spec_for(name)
    jmat = _jax_plan(spec)["mat"]
    bop = fold_mul.mma_operand(spec)
    (n_pad, k_pad), (rows, nbytes) = SHAPES[name]
    assert jmat.shape == (rows, nbytes)
    assert bop.dtype == np.int8 and bop.shape == (n_pad, k_pad) and bop.flags["C_CONTIGUOUS"]
    assert n_pad % fold_mul.MMA_N == 0 and k_pad % fold_mul.MMA_K == 0
    assert np.array_equal(bop[:nbytes, :rows], jmat.T)
    assert not bop[nbytes:].any() and not bop[:, rows:].any()


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_tile_pieces_hold_the_jax_columns(name):
    import jax.numpy as jnp
    from vote_saver_tpu.ops import fold_mul as jfm

    spec, xs, ys = _lanes(name, 21, 90 + (name == "fr"))
    a, b = _raw(xs, spec), _raw(ys, spec)
    rows = fold_mul.tile_pieces(spec, a, b)
    (_n_pad, k_pad), (nrows, _nbytes) = SHAPES[name]
    assert rows.dtype == torch.uint8 and rows.shape == (len(xs), k_pad)
    jp = _jax_plan(spec)
    a16, b16 = (jnp.asarray(np.array([[(v >> (16 * k)) & 0xFFFF for k in range(jp["L"])] for v in vals],
                                     np.uint32).T) for vals in (xs, ys))  # (L, lanes): digit_rows' layout
    cols = jfm.product_columns(jp, jfm.digit_rows(jp, a16), jfm.digit_rows(jp, b16))
    cols = np.stack([np.asarray(c) for c in cols], axis=-1).astype(np.int64)  # (lanes, ncols), exact
    pieces = ((cols[..., None] >> np.array([0, 8, 16])) & 255).reshape(len(xs), -1)  # row 3c + t
    assert np.array_equal(rows[:, :nrows].numpy(), pieces)
    assert not rows[:, nrows:].any()
    assert rows[0, :3].tolist() == [1, 254, 0]  # 255 * 255 = 0xFE01: the all-255 lane's column 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_tile_model_matches_plain_and_jax(env16, name, seed):  # noqa: F811
    import jax.numpy as jnp
    import vote_saver_tpu.ops.fold_mul as jfm

    n = 2 * fold_mul.TILE_LANES + 7  # three tiles, the last ragged
    spec, xs, ys = _lanes(name, n, 170 + 2 * seed + (name == "fr"))
    N = spec.modulus
    a, b = _raw(xs, spec), _raw(ys, spec)
    want = [x * y * pow(spec.mont_r, -1, N) % N for x, y in zip(xs, ys)]
    tile = fold_mul.mul_fold_tile(spec, a, b)
    assert list(lb.tensor_to_ints(tile, spec, mont=False)) == want
    assert torch.equal(tile, fold_mul.mul_fold_plain(spec, a, b))
    spec16 = env16["params"].fq_spec() if name == "fq" else env16["params"].fr_spec()
    a16 = np.array([spec16.to_limbs(x) for x in xs], np.uint32)
    b16 = np.array([spec16.to_limbs(y) for y in ys], np.uint32)
    jfold = np.asarray(jfm.mul_fold_spec(spec16, jnp.asarray(a16), jnp.asarray(b16)))
    assert [spec16.from_limbs(r) for r in jfold] == want


_SASS = """
	code for sm_90a
		Function : _Z15k_mul_chain_mmaI8FqParamsLi1ELi16EEvPKjS2_PjS3_x
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a30*/                   FFMA R21, R145, R53, R68 ;
        /*0a40*/                   LDSM.16.M88.4 R40, [R2] ;
        /*0a50*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0a60*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0a70*/              @!P0 BRA 0x1a0 ;
		Function : _Z11k_mul_chainI8FqParams5MulV1Li4ELi6EEvPKjS2_PjS3_x
        /*0100*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0110*/                   EXIT ;
		Function : _Z8mul_foldI8FqParamsE2FpIT_ES3_S3_
        /*0200*/                   IDP.4A.U8.S8 R4, R8, c[0x3][0x0], R4 ;
"""


def test_sass_counts_name_each_kernel():
    """chip_smoke.py holds the fold probes to the tensor cores through
    cuobjdump's SASS: IMMA, IDP, FFMA and all instructions counted per
    kernel, predicated ones included, under the kernels line's names; a
    device function is no kernel of that line."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    assert chip_smoke.sass_counts(_SASS) == {
        "mul_chain_k10_fold": {"IMMA": 2, "IDP": 0, "FFMA": 1, "all": 5},
        "mul_chain_k7_v1": {"IMMA": 0, "IDP": 0, "FFMA": 0, "all": 2}}
