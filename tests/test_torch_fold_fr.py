"""The fold mode's Fr inversion chain with its fold product on the int8
tensor cores (``csrc/curve_fold.cu``: ``k_mont_inv<FrParams,
MulFoldMmaOf<FrParams>>``), on the CPU, against the JAX package.

On the card each Fr multiply of the chain runs the tensor-core fold of
``csrc/fold_mma.cuh`` in Fr: a warp's 32 lanes of byte pieces (K = 192) as
one A tile against Fr's B operand (``fold_mul.mma_operand(FR)``, N = 40
output bytes), 2 x 5 x 6 = 60 ``mma.sync`` a multiply, the lanes past n of a
ragged warp padding rows.  Its data flow in plain PyTorch is
``fold_mul.mul_fold_tile(FR, ...)``; ``TileFr`` is an Fr whose multiply is
that tile model.  Here: the tile multiply equals the JAX package's K1 body
in Fr under ``VSTPU_MUL=fold`` (``FqEmitFold(fr_spec())``, the body of
``_mul_call``, its fold matrix bound as ``_fold_inputs`` binds it), the
plain K1 and Python's integers on 0, 1, r - 1, R mod r and random lanes;
the Fermat chain as ``k_mont_inv`` runs it (``hopper_field.mont_inv_plain``
over ``TileFr``: the top bit of r - 2 seeds the result, a square per
further bit, a multiply per set bit) at 16 lanes (the device witness's)
and at a ragged 37 equals ``mont_inv_plain`` and ``pow(x, r - 2, r)``, 0
mapping to 0; Fr's B operand is 40 x 192 bytes.  The JAX multiply runs
eagerly, op by op (about a second), not compiled (tens of seconds).  Exact
equality throughout.

    python -m pytest tests/test_torch_fold_fr.py -q -p no:cacheprovider
"""

import random

import numpy as np
import pytest
import torch

from test_torch_curve import env16  # noqa: F401
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import fold_mul
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import torch_threads

R = lb.FR.modulus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


class TileFr(hf.HalfField):
    """Fr whose multiply is the tensor-core fold's data flow: the lanes of
    the flattened batch in tiles of 32, each tile's pieces times Fr's B
    operand (``fold_mul.mul_fold_tile``); every other operation
    HalfField's."""

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        L = lb.FR.num_limbs
        out = fold_mul.mul_fold_tile(lb.FR, hf._pack(a).reshape(-1, L), hf._pack(b).reshape(-1, L))
        return hf._half(out).reshape(a.shape)


def _lanes(n: int, seed: int) -> list[int]:
    """0, 1, r - 1, R mod r, then random elements of Fr."""
    rnd = random.Random(seed)
    return [0, 1, R - 1, lb.FR.mont_r % R] + [rnd.randrange(R) for _ in range(n - 4)]


def test_fr_operand_is_40_by_192():
    bop = fold_mul.mma_operand(lb.FR)
    assert bop.shape == (40, 192) and bop.dtype == np.int8
    assert fold_mul.mma_operand(lb.FQ).shape == (56, 288)


def test_fr_tile_multiply_matches_the_fold_pallas_k1(env16):  # noqa: F811
    """The Fr multiply on the tile (two tiles, the second ragged): the
    plain K1 in fold, Python's integers and the JAX K1 body through
    ``FqEmitFold`` in Fr, its matrix bound as ``_fold_inputs`` binds it."""
    xs, ys = _lanes(37, 200), list(reversed(_lanes(37, 201)))
    a, b = lb.ints_to_tensor(xs, lb.FR), lb.ints_to_tensor(ys, lb.FR)
    f = TileFr(lb.FR)
    got = hf._pack(f.mul(hf._half(a), hf._half(b)))
    assert torch.equal(got, hf.mont_mul_plain("fr", a, b, "fold"))
    assert list(lb.tensor_to_ints(got, lb.FR)) == [x * y % R for x, y in zip(xs, ys)]
    pf, jlb = env16["pf"], env16["lb"]
    spec = env16["params"].fr_spec()
    e = pf._make_emit(spec, "fold")
    extras, _specs, bind = pf._fold_inputs(e)
    bind(extras[0])

    def cols(vals):
        return np.asarray(jlb.ints_to_mont_limbs(vals, spec)).T  # (L16, lanes)

    jout = e.mul(cols(xs), cols(ys))
    assert torch.equal(got, convert.from_jax_limbs(np.asarray(jout).T))


@pytest.mark.parametrize("lanes", [16, 37])
def test_fermat_chain_on_the_tile_matches_plain_and_pow(lanes, monkeypatch):
    """k_mont_inv<FrParams, MulFoldMmaOf<FrParams>>'s chain: 254 squares and
    163 multiplies, each a tile multiply over the lanes, at the device
    witness's 16 lanes (half a tile) and at 37 (a ragged second tile)."""
    xs = _lanes(lanes, 210 + lanes)
    a = lb.ints_to_tensor(xs, lb.FR)
    want = hf.mont_inv_plain("fr", a)
    monkeypatch.setitem(hf.HALF, "fr", TileFr(lb.FR))
    got = hf.mont_inv_plain("fr", a)
    assert torch.equal(got, want)
    assert list(lb.tensor_to_ints(got, lb.FR)) == [pow(x, R - 2, R) for x in xs]
    assert not got[0].any()
