"""The port's field layer against the JAX package and the Python-int oracle.

Inputs are made from seeded ``random`` and fed to both sides; every
comparison is exact (integer arithmetic: tolerance zero).  The JAX side runs
its 32-bit CPU-rig layout (``VSTPU_LIMB_BITS=32``, tests/conftest.py); the
port's tensors carry across through ``vote_saver_tpu_torch.convert``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vote_saver_tpu.ops import field_ops as jfo
from vote_saver_tpu.ops import fq2_ops as jfq2
from vote_saver_tpu.params import Q, R
from vote_saver_tpu.refimpl import field as rf
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import field_ops as tfo
from vote_saver_tpu_torch.ops import fq2_ops as tfq2
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


FIELDS = {"fr": (R, lb.FR, tfo.fr_ops, jfo.fr_ops), "fq": (Q, lb.FQ, tfo.fq_ops, jfo.fq_ops)}


def _vals(N, n, seed):
    rnd = random.Random(seed)
    return [0, 1, N - 1, N - 1, 2] + [rnd.randrange(N) for _ in range(n)]


def _jax(t):
    return jnp.asarray(convert.to_jax_limbs(t, 32))


def _back(a):
    return convert.from_jax_limbs(np.asarray(a))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_ops_match_jax_and_oracle(name):
    N, spec, tops, jops = FIELDS[name]
    f, jf = tops(), jops()
    xs = _vals(N, 59, 1)
    ys = [N - 1, 1, N - 1, 0, N - 2] + _vals(N, 59, 2)[5:]
    a, b = lb.ints_to_tensor(xs, spec), lb.ints_to_tensor(ys, spec)
    ja, jb = _jax(a), _jax(b)
    cases = {
        "mul": (f.mul(a, b), jf.mul(ja, jb), [x * y % N for x, y in zip(xs, ys)]),
        "sq": (f.sq(a), jf.sq(ja), [x * x % N for x in xs]),
        "add": (f.add(a, b), jf.add(ja, jb), [(x + y) % N for x, y in zip(xs, ys)]),
        "sub": (f.sub(a, b), jf.sub(ja, jb), [(x - y) % N for x, y in zip(xs, ys)]),
        "neg": (f.neg(a), jf.neg(ja), [(-x) % N for x in xs]),
    }
    for op, (got, jgot, exp) in cases.items():
        assert torch.equal(got, _back(jgot)), op
        assert list(lb.tensor_to_ints(got, spec)) == exp, op
    std = lb.to_tensor(lb.ints_to_limbs(xs, spec))
    assert torch.equal(f.to_mont(std), a)
    assert torch.equal(f.from_mont(a), std)
    assert torch.equal(f.to_mont(std), _back(jf.to_mont(_jax(std))))
    assert torch.equal(f.is_zero(a), torch.tensor([x == 0 for x in xs]))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_inverse_and_reduce_lazy(name):
    N, spec, tops, jops = FIELDS[name]
    f, jf = tops(), jops()
    xs = [1, N - 1, 2, 12345, random.Random(3).randrange(1, N)]
    a = lb.ints_to_tensor(xs, spec)
    inv = f.inv(a)
    assert list(lb.tensor_to_ints(inv, spec)) == [pow(x, N - 2, N) for x in xs]
    assert torch.equal(inv, _back(jf.inv(_jax(a))))
    # lazy sums of up to 254 canonical values, as the COO matvec builds them
    rnd = random.Random(4)
    rows = [[rnd.randrange(N) for _ in range(k)] for k in (1, 7, 254)]
    cols = torch.stack([lb.ints_to_tensor(r, spec).to(torch.int64).bitwise_and(0xFFFFFFFF).sum(0) for r in rows])
    got = f.reduce_lazy(cols)
    rinv = pow(spec.mont_r, N - 2, N)
    exp = [sum(spec.to_mont(v) for v in r) * rinv % N for r in rows]
    assert list(lb.tensor_to_ints(got, spec, mont=False)) == exp
    jcols = jnp.asarray(cols.numpy().astype(np.uint64))
    assert torch.equal(got, _back(jf.reduce_lazy(jcols)))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_plain_k1_matches_oracle(name):
    """The plain version of kernel K1, on the public int32 layout."""
    N, spec, _tops, jops = FIELDS[name]
    xs, ys = _vals(N, 251, 5), _vals(N, 251, 6)
    a, b = lb.ints_to_tensor(xs, spec), lb.ints_to_tensor(ys, spec)
    got = hf.mont_mul_plain(name, a, b)
    assert got.dtype == torch.int32 and got.shape == a.shape
    assert list(lb.tensor_to_ints(got, spec)) == [x * y % N for x, y in zip(xs, ys)]
    assert torch.equal(got, _back(jops().mul(_jax(a), _jax(b))))
    # the CPU wrapper runs the plain version and launches nothing
    before = dict(hf.launches)
    assert torch.equal(hf.mont_mul(name, a, b), got)
    assert hf.launches == before


def test_fq2_ops_match_jax_and_oracle():
    f2, jf2 = tfq2.fq2_ops(), jfq2.fq2_ops()
    rnd = random.Random(7)
    xs = [(0, 0), (1, 0), (Q - 1, Q - 1)] + [(rnd.randrange(Q), rnd.randrange(Q)) for _ in range(29)]
    ys = [(Q - 1, 1), (1, 0), (Q - 1, 0)] + [(rnd.randrange(Q), rnd.randrange(Q)) for _ in range(29)]
    a, b = lb.ints_to_tensor(xs, lb.FQ), lb.ints_to_tensor(ys, lb.FQ)
    assert a.shape == (32, 2, 12)

    def ints(t):
        return [tuple(int(v) for v in row) for row in lb.tensor_to_ints(t, lb.FQ)]

    assert ints(f2.mul(a, b)) == [rf.fq2_mul(x, y) for x, y in zip(xs, ys)]
    assert ints(f2.sq(a)) == [rf.fq2_sq(x) for x in xs]
    assert ints(f2.add(a, b)) == [rf.fq2_add(x, y) for x, y in zip(xs, ys)]
    assert ints(f2.sub(a, b)) == [rf.fq2_sub(x, y) for x, y in zip(xs, ys)]
    for got, jgot in ((f2.mul(a, b), jf2.mul(_jax(a), _jax(b))), (f2.sq(a), jf2.sq(_jax(a))),
                      (f2.neg(a), jf2.neg(_jax(a)))):
        assert torch.equal(got, _back(jgot))
    nz = a[3:7]
    assert ints(f2.inv(nz)) == [rf.fq2_inv(x) for x in xs[3:7]]
    assert torch.equal(f2.inv(nz), _back(jf2.inv(_jax(nz))))


def test_limb_layouts_and_convert():
    rnd = random.Random(8)
    xs = [0, 1, Q - 1] + [rnd.randrange(Q) for _ in range(13)]
    t = lb.ints_to_tensor(xs, lb.FQ, mont=False)
    assert t.dtype == torch.int32
    assert list(lb.tensor_to_ints(t, lb.FQ, mont=False)) == xs
    # JAX 16-bit (uint32) and 32-bit (uint64) layouts repack to the same tensor
    s16 = convert.to_jax_limbs(t, 16)
    s32 = convert.to_jax_limbs(t, 32)
    assert s16.dtype == np.uint32 and s16.shape == (16, 24)
    assert s32.dtype == np.uint64 and s32.shape == (16, 12)
    assert torch.equal(convert.from_jax_limbs(s16), t)
    assert torch.equal(convert.from_jax_limbs(s32), t)
    assert [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in s16] == xs
