"""The device witness against the JAX package and the host witness, exactly.

  * ``EdwardsOps.add`` and ``sum_reduce`` (JubJub over Fr) against the JAX
    ``jj_ops``, limb for limb, and against ``refimpl`` on affine points;
  * ``batch_inv_axis`` and ``_pedersen_core`` against the JAX functions at a
    small window count, on seeded numpy inputs (the Pedersen window
    constants carried across by ``convert.pedersen_tables_from_jax``);
  * ``generate_witness_device`` at depth 2 (3 voters) against
    ``circ.generate_witness``, value for value, and the R1CS holds.

The JAX side runs in the 32-bit CPU layout (uint64 limbs), which
``convert`` repacks into this package's int32 tensors.
"""

import jax
import numpy as np
import pytest
import torch

from vote_saver_tpu.circuit import witness_dev as jwd
from vote_saver_tpu.circuit.gadgets import _window_constants
from vote_saver_tpu.circuit.voting import build_voting_circuit
from vote_saver_tpu.ops import curve_ops as jco
from vote_saver_tpu.ops import field_ops as jfo
from vote_saver_tpu.ops import limbs as jlb
from vote_saver_tpu.params import PUBLIC_KEY_BITS, R, SECRET_KEY_BITS
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import pedersen as rpd
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.circuit import witness_dev as wd
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import merkle
from vote_saver_tpu_torch.ops.field_ops import fr_ops
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jj_points(rnd, n):
    base = rpd.segment_generator(0)
    return [rc.jj_mul(base, int(k)) for k in rnd.integers(1, 2**62, size=n)]


def _eq(ours, theirs):
    return torch.equal(ours, convert.from_jax_limbs(np.asarray(theirs)))


def test_edwards_ops_match_jax():
    rnd = np.random.default_rng(61)
    p, q = _jj_points(rnd, 6), _jj_points(rnd, 6)
    P, Qd = co.jj_to_device(p), co.jj_to_device(q)
    jP, jQ = jco.jj_to_device(p), jco.jj_to_device(q)
    assert all(_eq(a, b) for a, b in zip(P, jP))
    jj, jjj = co.jj_ops(), jco.jj_ops()
    out = jj.add(P, Qd)
    assert all(_eq(a, b) for a, b in zip(out, jax.jit(jjj.add)(jP, jQ)))
    assert co.jj_from_device(out) == [rc.jj_add(a, b) for a, b in zip(p, q)]
    total = jj.sum_reduce(P)
    assert all(_eq(a, b) for a, b in zip(total, jax.jit(jjj.sum_reduce)(jP)))
    expect = p[0]
    for pt in p[1:]:
        expect = rc.jj_add(expect, pt)
    assert co.jj_from_device(tuple(c[None] for c in total)) == [expect]
    ident = jj.identity_like(P[0])
    assert co.jj_from_device(jj.add(P, ident)) == p
    assert all(_eq(a, b) for a, b in zip(ident, jjj.identity_like(jP[0])))


def test_batch_inv_axis_matches_jax():
    rnd = np.random.default_rng(62)
    vals = [[int(v) % R or 1 for v in rnd.integers(1, 2**62, size=7)] for _ in range(3)]
    x = lb.ints_to_tensor(vals, lb.FR)
    got = wd.batch_inv_axis(fr_ops(), x, axis=1)
    theirs = jax.jit(lambda a: jwd.batch_inv_axis(jfo.fr_ops(), a, axis=1))(convert.to_jax_limbs(x, 32))
    assert _eq(got, theirs)
    assert [list(r) for r in lb.tensor_to_ints(got, lb.FR)] == [[pow(v, R - 2, R) for v in row] for row in vals]


@pytest.mark.parametrize("W,nbits", [(5, 14), (1, 3)])
def test_pedersen_core_matches_jax(W, nbits):
    rnd = np.random.default_rng(63 + W)
    consts = _window_constants(W)
    spec = jfo.fr_ops().spec
    jxs4 = jlb.ints_to_mont_limbs([[p[0] for p in row] for row in consts], spec)
    jys4 = jlb.ints_to_mont_limbs([[p[1] for p in row] for row in consts], spec)
    xs4, ys4 = convert.pedersen_tables_from_jax(jxs4, jys4)
    bits = rnd.integers(0, 2, size=(3, nbits)).astype(np.int32)
    ours = wd._pedersen_core(fr_ops(), co.jj_ops(), xs4, ys4, torch.from_numpy(bits), W)
    theirs = jax.jit(lambda x, y, b: jwd._pedersen_core(jfo.fr_ops(), jco.jj_ops(), x, y, b, W))(jxs4, jys4, bits)
    assert np.array_equal(ours[0].numpy(), np.asarray(theirs[0]))  # t
    for k in (1, 3, 4):  # xw, last affine x, y
        assert _eq(ours[k], theirs[k])
    assert (ours[2] is None) == (theirs[2] is None) == (W == 1)
    if W > 1:
        assert _eq(ours[2], theirs[2])  # EdwardsAdd internals
    # the digest point is the out-of-circuit Pedersen point of these bits
    ax, ay = (lb.tensor_to_ints(c, lb.FR) for c in ours[3:])
    assert [(int(x), int(y)) for x, y in zip(ax, ay)] == [rpd.pedersen_point([int(v) for v in b]) for b in bits]


@pytest.fixture(scope="module")
def depth2():
    rng = FrRandom(0xD2)
    circ = build_voting_circuit(2, 64)
    sks = [rng.bits(SECRET_KEY_BITS) for _ in range(3)]
    pks = [rpd.pedersen_hash(sk) for sk in sks] + [[0] * PUBLIC_KEY_BITS]
    levels = merkle.build_tree(np.array(pks, np.int32), device="host")
    eid = [rng() % 2 for _ in range(64)]
    return circ, sks, levels, eid


def test_device_witness_matches_host(depth2):
    circ, sks, levels, eid = depth2
    votes, vidx = np.array([5, 5, 17]), np.array([0, 1, 2])
    sib = np.stack([merkle.copath(levels, i) for i in vidx]).astype(object)
    host = circ.generate_witness(votes, np.array(eid, dtype=object), np.array(sks, dtype=object), vidx, sib)
    w = wd.generate_witness_device(circ, votes, eid, sks, vidx, sib, "cpu")
    assert w.shape == (3, circ.cs.num_vars, 8) and w.dtype == torch.int32
    got = wd.witness_to_host_ints(w)
    mism = np.nonzero(got != host.values)
    assert len(mism[0]) == 0, f"first mismatches at {list(zip(*mism))[:10]}"
    assert circ.cs.is_satisfied(got)
