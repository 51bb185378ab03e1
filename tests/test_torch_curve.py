"""Plain versions of kernels K2-K4 against the Pallas formulas, limb for limb.

The JAX side runs ``pallas_field._jac_madd``, ``_jac_add(complete=True)`` and
``_jac_double`` over the ``FqEmit`` emitter eagerly on CPU in the 16-bit
Pallas layout (fresh module copies under ``VSTPU_LIMB_BITS=16``, swapped into
``sys.modules`` and restored, as tests/test_pallas_kernels.py does); its
outputs carry across through ``vote_saver_tpu_torch.convert`` and must equal
the port's plain versions exactly — canonical infinity (1, 1, 0) and the
madd ``exc`` flag included.  Every special lane is covered: infinite
operands, p == q, p == -q, (0, 0) / inactive madd lanes and the doubling
corner (``vote_saver_tpu_torch.testing.special_lanes``, which chip_smoke.py
also feeds the kernels on the card).  The port's curve helpers are checked
against ``refimpl``.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import MADD_EXC, neg_y, special_lanes, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def env16():
    """Fresh JAX-package module copies under the 16-bit limb layout."""
    old_limb = os.environ.get("VSTPU_LIMB_BITS")
    os.environ["VSTPU_LIMB_BITS"] = "16"
    mods = [m for m in sys.modules if m.startswith("vote_saver_tpu") and not m.startswith("vote_saver_tpu_torch")]
    saved = {m: sys.modules.pop(m) for m in mods}
    import vote_saver_tpu.ops.limbs as jlb
    import vote_saver_tpu.ops.pallas_field as pf
    import vote_saver_tpu.params as params

    yield dict(params=params, lb=jlb, pf=pf)
    for m in [m for m in sys.modules if m.startswith("vote_saver_tpu") and not m.startswith("vote_saver_tpu_torch")]:
        sys.modules.pop(m)
    sys.modules.update(saved)
    if old_limb is None:
        os.environ.pop("VSTPU_LIMB_BITS", None)
    else:
        os.environ["VSTPU_LIMB_BITS"] = old_limb


def _port(points, ncoords):
    return tuple(lb.ints_to_tensor([pt[k] for pt in points], lb.FQ) for k in range(ncoords))


def _jax_cols(points, ncoords, g2, env):
    """Host ints -> the emitter layout: (L16, B) per Fq coordinate."""
    spec, jlb = env["params"].fq_spec(), env["lb"]

    def cols(vals):
        return np.asarray(jlb.ints_to_mont_limbs(vals, spec)).T

    out = []
    for k in range(ncoords):
        vals = [pt[k] for pt in points]
        out.append((cols([v[0] for v in vals]), cols([v[1] for v in vals])) if g2 else cols(vals))
    return tuple(out)


def _from_jax(coord, g2):
    if g2:
        return convert.from_jax_limbs(np.stack([np.asarray(coord[0]).T, np.asarray(coord[1]).T], axis=1))
    return convert.from_jax_limbs(np.asarray(coord).T)


def _emitter(env, g2):
    # the unrolled emitter: same canonical values as the loop-CIOS default,
    # and cheap to run eagerly (no per-multiply loop trace)
    e = env["pf"].FqEmit(env["params"].fq_spec())
    return env["pf"].Fq2Emit(e) if g2 else e


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_madd_matches_pallas_formula(env16, g2):
    import jax.numpy as jnp

    _p, _q, acc, qm, sign, active = special_lanes(g2, 8, random.Random(11 + g2))
    out, exc = hf.madd_plain(g2, _port(acc, 3), _port(qm, 2), torch.tensor(sign), torch.tensor(active))
    jout, jexc = env16["pf"]._jac_madd(
        _emitter(env16, g2), _jax_cols(acc, 3, g2, env16), _jax_cols(qm, 2, g2, env16),
        jnp.asarray(sign), jnp.asarray(active),
    )
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    assert exc.tolist() == [int(bool(x)) for x in np.asarray(jexc)] == MADD_EXC
    # the lanes that are not the corner hold the right points
    got = (co.g2_from_device if g2 else co.g1_from_device)(out)
    add = rc.g2_add if g2 else rc.g1_add
    for i in (0, 1, 3, 5, 6, 7):
        aff_acc = rj.jac_to_affine(acc[i], "g2" if g2 else "g1") if acc[i][2] not in (0, (0, 0)) else None
        qq = qm[i] if not sign[i] else (qm[i][0], neg_y(qm[i][1], g2))
        assert got[i] == (add(aff_acc, qq) if active[i] else aff_acc), i
    # the CPU wrapper is the plain version
    wrap = hf.g2_madd if g2 else hf.g1_madd
    wout, wexc = wrap(_port(acc, 3), _port(qm, 2), torch.tensor(sign), torch.tensor(active))
    assert all(torch.equal(a, b) for a, b in zip(wout, out)) and torch.equal(wexc, exc)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_complete_add_matches_pallas_formula(env16, g2):
    p, q, *_ = special_lanes(g2, 8, random.Random(21 + g2))
    out = hf.add_plain(g2, _port(p, 3), _port(q, 3))
    jout = env16["pf"]._jac_add(_emitter(env16, g2), _jax_cols(p, 3, g2, env16), _jax_cols(q, 3, g2, env16),
                                complete=True)
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    one = lb.ints_to_tensor([(1, 0)] if g2 else [1], lb.FQ)[0]
    assert torch.equal(out[0][5], one) and torch.equal(out[1][5], one) and not out[2][5].any()
    group = "g2" if g2 else "g1"
    add = rc.g2_add if g2 else rc.g1_add
    aff = [None if pt[2] in (0, (0, 0)) else rj.jac_to_affine(pt, group) for pt in p]
    affq = [None if pt[2] in (0, (0, 0)) else rj.jac_to_affine(pt, group) for pt in q]
    got = (co.g2_from_device if g2 else co.g1_from_device)(out)
    assert got == [add(a, b) for a, b in zip(aff, affq)]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_double_matches_pallas_formula(env16, g2):
    p, *_ = special_lanes(g2, 8, random.Random(31 + g2))
    out = hf.double_plain(g2, _port(p, 3))
    jout = env16["pf"]._jac_double(_emitter(env16, g2), _jax_cols(p, 3, g2, env16))
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    assert not out[2][0].any()  # doubling infinity stays infinity


def test_curve_helpers_match_oracle():
    rnd = random.Random(41)
    pts = [rc.g1_mul(rc.g1_gen, rnd.randrange(1, 1 << 64)) for _ in range(3)] + [None]
    g1 = co.g1_ops()
    dev = co.g1_to_device(pts)
    ax, ay = g1.to_affine(dev)
    assert list(lb.tensor_to_ints(ax, lb.FQ)) == [p[0] if p else 0 for p in pts]
    assert list(lb.tensor_to_ints(ay, lb.FQ)) == [p[1] if p else 0 for p in pts]
    ks = [rnd.randrange(1 << 24) for _ in pts[:3]]
    digits = torch.tensor([[(k >> (4 * w)) & 15 for w in range(6)] for k in ks])
    got = co.g1_from_device(g1.scalar_mul_windowed(co.g1_to_device(pts[:3]), digits))
    assert got == [rc.g1_mul(p, k) for p, k in zip(pts[:3], ks)]
    total = co.g1_from_device(tuple(c[None] for c in g1.sum_reduce(dev)))[0]
    assert total == rc.g1_add(rc.g1_add(pts[0], pts[1]), pts[2])
    g2pts = [rc.g2_mul(rc.g2_gen, rnd.randrange(1, 1 << 64)) for _ in range(2)]
    g2 = co.g2_ops()
    bx, by = g2.to_affine(co.g2_to_device(g2pts))
    assert [tuple(int(v) for v in r) for r in lb.tensor_to_ints(bx, lb.FQ)] == [p[0] for p in g2pts]
    assert co.g2_from_device(g2.double(co.g2_to_device(g2pts))) == [rc.g2_add(p, p) for p in g2pts]
