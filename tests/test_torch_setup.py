"""Groth16 setup on the device against the JAX package and the host arm.

  * kernel K3d's plain version (``add_distinct_plain``, the distinct-operand
    Jacobian add) against the JAX ``JacobianOps.add_distinct`` (32-bit CPU
    layout) and against ``pallas_field._jac_add(..., complete=False)`` over
    the ``FqEmit`` emitter under the 16-bit Pallas layout, limb for limb on
    the special lanes of ``vote_saver_tpu_torch.testing`` (the h = 0 lanes
    give the formula's own (x3, y3, 0), not canonical infinity);
  * ``FixedBaseTable``: the table equals the JAX one (carried across by
    ``convert.fixed_base_table_from_jax``), and so do its digits and its
    products, 0 and 1 among the scalars;
  * the device arm of ``groth16.setup`` on a toy R1CS writes blobs
    byte-identical to the host-native arm's.
"""

import random

import jax
import numpy as np
import pytest
import torch

from test_torch_curve import _emitter, _from_jax, _jax_cols, _port, env16  # noqa: F401
from test_torch_groth16 import _toy_circuit
from vote_saver_tpu.ops import curve_ops as jco
from vote_saver_tpu.ops import msm as jmsm
from vote_saver_tpu.params import R
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm
from vote_saver_tpu_torch.protocol import groth16 as tg
from vote_saver_tpu_torch.testing import special_lanes, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _check_h_zero_lanes(out, g2):
    """Lanes 3 (p + p, same limbs) and 4 (p + p, another Z): z3 = 0 with the
    formula's x3 / y3, which are not canonical infinity's (1, 1)."""
    one = lb.ints_to_tensor([(1, 0)] if g2 else [1], lb.FQ)[0]
    for lane in (3, 4):
        assert not out[2][lane].any()
        assert not torch.equal(out[0][lane], one)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_add_distinct_matches_jax(g2):
    p, q, *_ = special_lanes(g2, 8, random.Random(51 + g2))
    P, Qd = _port(p, 3), _port(q, 3)
    out = hf.add_distinct_plain(g2, P, Qd)
    ops = jco.g2_ops() if g2 else jco.g1_ops()
    jout = jax.jit(ops.add_distinct)(tuple(convert.to_jax_limbs(c, 32) for c in P),
                                     tuple(convert.to_jax_limbs(c, 32) for c in Qd))
    for got, exp in zip(out, jout):
        assert torch.equal(got, convert.from_jax_limbs(np.asarray(exp)))
    _check_h_zero_lanes(out, g2)
    # lanes 0-2 (an infinite operand) and the generic lanes hold the sums
    group, add = ("g2", rc.g2_add) if g2 else ("g1", rc.g1_add)
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    got, aff_p, aff_q = from_dev(out), from_dev(P), from_dev(Qd)
    assert [got[i] for i in (0, 1, 2, 6, 7)] == [add(aff_p[i], aff_q[i]) for i in (0, 1, 2, 6, 7)]
    # the CPU wrapper is the plain version
    wrap = hf.g2_add_distinct if g2 else hf.g1_add_distinct
    assert all(torch.equal(a, b) for a, b in zip(wrap(P, Qd), out))
    assert hf.launches["g2_add_distinct" if g2 else "g1_add_distinct"] == 0


def test_fixed_base_table_matches_jax():
    jt = jmsm.FixedBaseTable(rc.g1_gen, "g1")
    tbl = msm.FixedBaseTable(rc.g1_gen, "g1")
    assert (tbl.window_bits, tbl.num_windows) == (jt.window_bits, jt.num_windows) == (8, 32)
    for ours, theirs in zip(tbl.table, convert.fixed_base_table_from_jax(jt.table)):
        assert torch.equal(ours, theirs)
    rng = random.Random(52)
    ks = [rng.randrange(R) for _ in range(6)] + [0, 1, R - 1]
    assert np.array_equal(tbl.digits(ks), jt.digits(ks))
    out = tbl.mul(co.g1_ops(), tbl.digits(ks))
    jout = jax.jit(lambda d: jt.mul(jco.g1_ops(), d))(jt.digits(ks))
    for got, exp in zip(out, jout):
        assert torch.equal(got, convert.from_jax_limbs(np.asarray(exp)))
    assert co.g1_from_device(out) == [rc.g1_mul(rc.g1_gen, k) if k else None for k in ks]


def test_g2_fixed_base_table_products():
    tbl = msm.FixedBaseTable(rc.g2_gen, "g2")
    rng = random.Random(53)
    ks = [rng.randrange(R) for _ in range(3)] + [0, 1]
    got = co.g2_from_device(tbl.mul(co.g2_ops(), tbl.digits(ks)))
    assert got == [rc.g2_mul(rc.g2_gen, k) if k else None for k in ks]


def test_device_setup_matches_host_arm(monkeypatch):
    cs, _witness = _toy_circuit()
    pk, vk = tg.setup(cs, FrRandom(54), device="host")
    # 64-scalar chunks: the toy CRS spans several chunks and a zero-padded
    # last one, at a width the plain versions run quickly on the CPU
    monkeypatch.setattr(tg, "_FB_CHUNK", 64)
    dpk, dvk = tg.setup(cs, FrRandom(54), device="cpu")
    assert M.ser_groth16_pk(dpk) == M.ser_groth16_pk(pk)
    assert M.ser_groth16_vk(dvk) == M.ser_groth16_vk(vk)
    # zero scalars give infinity on both arms (v of a wire absent from B)
    assert None in pk.b2_pts and dpk.b2_pts == pk.b2_pts


# the emitter tests swap the JAX modules for 16-bit copies: they run last
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_add_distinct_matches_pallas_formula(env16, g2):  # noqa: F811
    p, q, *_ = special_lanes(g2, 8, random.Random(55 + g2))
    out = hf.add_distinct_plain(g2, _port(p, 3), _port(q, 3))
    jout = env16["pf"]._jac_add(_emitter(env16, g2), _jax_cols(p, 3, g2, env16), _jax_cols(q, 3, g2, env16),
                                complete=False)
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    _check_h_zero_lanes(out, g2)
