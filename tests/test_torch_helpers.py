"""The helpers that no path calls, and ``entry()``, against the JAX package.

  * ``FieldOps.eq`` / ``pow_fixed`` / ``batch_inv`` in Fr and Fq,
    ``Fq2Ops.eq``, ``JacobianOps.scalar_mul_bits`` in G1 and G2,
    ``curve_ops.scalars_to_bits_msb`` and ``msm.msm_pippenger``, each equal
    to its JAX counterpart exactly (limbs, Montgomery or Jacobian, and
    bits), on inputs from one seed;
  * ``entry.entry(device="cpu")``: its inputs and its forward step's
    output (a Jacobian G1 point) equal those of ``__graft_entry__.entry()``
    limb for limb.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vote_saver_tpu.ops import curve_ops as jco
from vote_saver_tpu.ops import field_ops as jfo
from vote_saver_tpu.ops import fq2_ops as jfq2
from vote_saver_tpu.ops import msm as jmsm
from vote_saver_tpu.params import Q, R
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu_torch import convert, entry
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import field_ops as fo
from vote_saver_tpu_torch.ops import fq2_ops as fq2
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm
from vote_saver_tpu_torch.testing import torch_threads

rnd = random.Random(0x4E1F)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax(t):
    return jnp.asarray(convert.to_jax_limbs(t, 32))


def _same(t, a) -> bool:
    return torch.equal(t, convert.from_jax_limbs(np.array(a)))


FIELDS = {"fr": (fo.fr_ops, jfo.fr_ops, lb.FR, R), "fq": (fo.fq_ops, jfo.fq_ops, lb.FQ, Q)}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_eq_pow_fixed_batch_inv_match_jax(field):
    ours, theirs, spec, p = FIELDS[field]
    t, j = ours(), theirs()
    xs = [rnd.randrange(1, p) for _ in range(8)]
    a = lb.ints_to_tensor(xs, spec)
    b = lb.ints_to_tensor(xs[:4] + [rnd.randrange(1, p) for _ in range(4)], spec)
    assert torch.equal(t.eq(a, b), torch.from_numpy(np.array(j.eq(_jax(a), _jax(b)))))
    assert t.eq(a, b).tolist() == [True] * 4 + [False] * 4
    bits = [1] + [rnd.randrange(2) for _ in range(23)]
    assert _same(t.pow_fixed(a, bits), jax.jit(lambda x: j.pow_fixed(x, bits))(_jax(a)))
    inv = t.batch_inv(a)
    assert _same(inv, jax.jit(j.batch_inv)(_jax(a)))
    assert list(lb.tensor_to_ints(inv, spec)) == [pow(x, p - 2, p) for x in xs]


def test_fq2_eq_matches_jax():
    xs = [(rnd.randrange(Q), rnd.randrange(Q)) for _ in range(6)]
    ys = xs[:2] + [(xs[2][0], rnd.randrange(Q)), (rnd.randrange(Q), xs[3][1])] + xs[4:]
    a, b = lb.ints_to_tensor(xs, lb.FQ), lb.ints_to_tensor(ys, lb.FQ)
    got = fq2.fq2_ops().eq(a, b)
    assert got.tolist() == [True, True, False, False, True, True]
    assert torch.equal(got, torch.from_numpy(np.array(jfq2.fq2_ops().eq(_jax(a), _jax(b)))))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_bits_matches_jax(group):
    """p * k bit by bit, MSB first, on 3 points with 12-bit scalars (one
    zero, one with the top bit clear), against the JAX scan."""
    mul, gen, to_dev, jto_dev, ops, jops = (
        (rc.g1_mul, rc.g1_gen, co.g1_to_device, jco.g1_to_device, co.g1_ops(), jco.g1_ops()) if group == "g1" else
        (rc.g2_mul, rc.g2_gen, co.g2_to_device, jco.g2_to_device, co.g2_ops(), jco.g2_ops()))
    pts = [mul(gen, rnd.randrange(1, R)) for _ in range(3)]
    ks = [0, rnd.randrange(1 << 10), rnd.randrange(1 << 11, 1 << 12)]
    bits = co.scalars_to_bits_msb(ks, 12)
    got = ops.scalar_mul_bits(to_dev(pts), bits)
    want = jax.jit(jops.scalar_mul_bits)(jto_dev(pts), bits)
    assert all(_same(g, w) for g, w in zip(got, want))
    from_dev = co.g1_from_device if group == "g1" else co.g2_from_device
    assert from_dev(got) == [None if k == 0 else mul(p, k) for p, k in zip(pts, ks)]


def test_scalars_to_bits_msb_matches_jax():
    ks = [0, 1, R - 1, rnd.randrange(R)]
    assert np.array_equal(co.scalars_to_bits_msb(ks), jco.scalars_to_bits_msb(ks))
    assert np.array_equal(co.scalars_to_bits_msb(ks, 16), jco.scalars_to_bits_msb(ks, 16))


def test_msm_pippenger_matches_jax():
    """8 points at w = 8: a zero scalar, two scalars sharing their low
    window (a run of two in one bucket) and random ones."""
    n = 8
    pts = [rc.g1_mul(rc.g1_gen, rnd.randrange(1, R)) for _ in range(n)]
    ks = [rnd.randrange(R) for _ in range(n)]
    ks[0] = 0
    ks[2] = (ks[1] & ~0xFF) | 0x5A
    ks[3] = (ks[3] & ~0xFF) | 0x5A
    got = msm.msm_pippenger(co.g1_ops(), co.g1_to_device(pts), lb.ints_to_limbs(ks, lb.FR))
    want = jax.jit(lambda p, s: jmsm.msm_pippenger(jco.g1_ops(), p, s))(
        jco.g1_to_device(pts), jmsm.scalars_to_limbs(ks))
    assert all(_same(g, w) for g, w in zip(got, want))
    assert co.g1_from_device(tuple(c[None] for c in got)) == [rc.g1_multiexp(pts, ks)]
    with pytest.raises(ValueError, match="divide"):
        msm.msm_pippenger(co.g1_ops(), co.g1_to_device(pts), lb.ints_to_limbs(ks, lb.FR), window_bits=5)


def test_entry_matches_graft_entry():
    step, evs = entry.entry(device="cpu")
    jstep, jevs = graft.entry()
    assert all(_same(t, j) for t, j in zip(evs, jevs))
    got = step(*evs)
    want = jax.jit(jstep)(*jevs)
    assert all(_same(g, w) for g, w in zip(got, want))
