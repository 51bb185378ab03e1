"""K5/K6, the flagged distinct add, and the MSM combination phase over it.

  * the plain ``addx`` against the Pallas formula ``_jac_addx`` (run eagerly
    on CPU in the 16-bit layout through the ``env16`` fixture), in G1 and
    G2: coordinates limb for limb and the ``exc`` flag, on the special lanes
    (p = q flagged, p = -q giving z3 = 0 unflagged, infinite operands);
  * ``_suffix_and_total`` and ``_horner`` with the complete adder against
    the JAX package's functions on the same buckets;
  * with the flagged adder: equal to the complete adder where no flag
    fires, and on a scheduled MSM through ``bucket_phase`` and
    ``combination_phase``; an empty bucket below a non-empty one makes two
    suffix partials equal and must raise the flag.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _emitter, _from_jax, _jax_cols, _port, env16  # noqa: F401
from vote_saver_tpu.ops import curve_ops as jco
from vote_saver_tpu.ops import msm_sched as jms
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch import native_bridge as nb
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.params import Q, R
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.testing import ADDX_EXC, jacobian, special_lanes, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _buckets(n: int, seed: int, empty=()):
    """n random G1 points as Jacobian device coords (random Z); the lanes in
    `empty` hold infinity (1, 1, 0).  Also returns the affine points."""
    rnd = random.Random(seed)
    aff = rj.FixedBaseHost(rc.g1_gen, "g1").mul_many([rnd.randrange(1, R) for _ in range(n)])
    for i in empty:
        aff[i] = None
    jac = [jacobian(a, rnd.randrange(1, Q), False) if a is not None else (1, 1, 0) for a in aff]
    return _port(jac, 3), aff


def _weighted(aff, K: int, bw: int):
    """Host S_w = sum_b (b + 1) a[w, b]."""
    out = []
    for w in range(K):
        acc = None
        for b in range(bw):
            acc = rc.g1_add(acc, rc.g1_mul(aff[w * bw + b], b + 1) if aff[w * bw + b] else None)
        out.append(acc)
    return out


def _jax(coords):
    return tuple(jnp.asarray(convert.to_jax_limbs(c, 32)) for c in coords)


def _back(coords):
    return tuple(convert.from_jax_limbs(np.asarray(c)) for c in coords)


def test_addx_adder_signature():
    p, _ = _buckets(3, 80)
    out, flag = ms._addx("g1")(p, p)
    assert flag is None  # the complete adder never flags, so it carries no flag
    assert all(torch.equal(a, b) for a, b in zip(out, co.g1_ops().add(p, p)))
    assert ms._addx("g1", distinct=True) is hf.g1_addx and ms._addx("g2", distinct=True) is hf.g2_addx
    _out, xflag = ms._addx("g1", distinct=True)(p, p)
    assert xflag.tolist() == [1, 1, 1]  # p + p with both finite is the doubling corner


def test_suffix_and_total_matches_jax():
    K, bw = 2, 4
    acc, aff = _buckets(K * bw, 81, empty=(2,))
    got, exc = ms._suffix_and_total(co.g1_ops(), ms._addx("g1"), acc, K, bw)
    jgot, jexc = jms._suffix_and_total(jco.g1_ops(), jms._addx("g1"), _jax(acc), K, bw)
    assert not bool(exc) and not bool(jexc)
    assert all(torch.equal(a, b) for a, b in zip(got, _back(jgot)))
    assert co.g1_from_device(got) == _weighted(aff, K, bw)


def test_horner_matches_jax():
    K, w, parts = 3, 3, 2
    sums, aff = _buckets(K * parts, 82)
    got, exc = ms._horner(co.g1_ops(), ms._addx("g1"), sums, w, parts, K - 1)
    jgot, jexc = jms._horner(jco.g1_ops(), jms._addx("g1"), _jax(sums), w, parts)
    assert not bool(exc) and not bool(jexc)
    assert all(torch.equal(a, b) for a, b in zip(got, _back(jgot)))
    for p in range(parts):
        want = None
        for j in range(K):
            want = rc.g1_add(want, rc.g1_mul(aff[p * K + j], 1 << (w * j)))
        assert co.g1_from_device(tuple(c[p : p + 1] for c in got)) == [want]
    # an empty (infinity) window on top changes no limb: starting below it
    # is what msm_device does
    inf = co.g1_ops().infinity_like(sums[0])
    padded = tuple(torch.cat([c.reshape(parts, K, -1), i.reshape(parts, K, -1)[:, :1]], dim=1).reshape(
        parts * (K + 1), -1) for c, i in zip(sums, inf))
    every, _ = ms._horner(co.g1_ops(), ms._addx("g1"), padded, w, parts, K)
    assert all(torch.equal(a, b) for a, b in zip(every, got))


def test_flagged_adder_matches_complete_where_no_flag_fires():
    K, bw, w = 2, 4, 3
    acc, _aff = _buckets(K * bw, 83)
    ops = co.g1_ops()
    sums, exc = ms._suffix_and_total(ops, ms._addx("g1"), acc, K, bw)
    xsums, xexc = ms._suffix_and_total(ops, ms._addx("g1", distinct=True), acc, K, bw)
    assert not bool(exc) and not bool(xexc)
    assert all(torch.equal(a, b) for a, b in zip(sums, xsums))
    res, _ = ms._horner(ops, ms._addx("g1"), sums, w, 1, K - 1)
    xres, xexc = ms._horner(ops, ms._addx("g1", distinct=True), sums, w, 1, K - 1)
    assert not bool(xexc) and all(torch.equal(a, b) for a, b in zip(res, xres))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_combination_phase_through_both_adders(g2):
    """One set of buckets of a scheduled MSM, combined by each adder."""
    rnd = random.Random(84 + g2)
    group, gen = ("g2", rc.g2_gen) if g2 else ("g1", rc.g1_gen)
    n = 12 if g2 else 40
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(n)])
    scalars = [rnd.randrange(1, 1 << 8) for _ in range(n)]
    sched = ms.build_schedule(scalars, 3, None, scalar_bits=8)
    to_dev = ms.g2_affine_to_device if g2 else ms.g1_affine_to_device
    buckets, bexc = ms.bucket_phase(group, to_dev(pts), sched)
    res, exc = ms.combination_phase(group, buckets, sched, ms._addx(group))
    assert not bool(bexc) and exc is None
    want = nb.msm(pts, scalars, group=group)
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    assert from_dev(res) == [want]
    full, _ = ms.msm_device(group, to_dev(pts), sched)
    assert all(torch.equal(a, b) for a, b in zip(full, res))
    xres, xexc = ms.combination_phase(group, buckets, sched, ms._addx(group, distinct=True))
    # the flag fires exactly where a window has an empty bucket below a
    # non-empty one (its suffix sum equals the next one's)
    bw = 1 << (sched.window_bits - 1)
    empty = (buckets[2].reshape(sched.num_windows, bw, -1) == 0).all(dim=-1).numpy()
    below = [any(empty[k, b] and not empty[k, b + 1:].all() for b in range(bw)) for k in range(sched.num_windows)]
    assert bool(xexc) == any(below)
    if not any(below):
        assert from_dev(xres) == [want]


def test_empty_bucket_below_a_non_empty_one_raises_the_flag():
    """Bucket 0 of window 0 is empty, bucket 1 is not: the suffix sums S_0
    and S_1 are equal, so the second pass adds equal operands."""
    K, bw = 1, 4
    acc, aff = _buckets(K * bw, 85, empty=(0,))
    sums, exc = ms._suffix_and_total(co.g1_ops(), ms._addx("g1"), acc, K, bw)
    assert not bool(exc) and co.g1_from_device(sums) == _weighted(aff, K, bw)
    _xsums, xexc = ms._suffix_and_total(co.g1_ops(), ms._addx("g1", distinct=True), acc, K, bw)
    assert bool(xexc), "equal suffix partials must raise the flag"


# the emitter tests swap the JAX modules for 16-bit copies: they run last
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_plain_addx_matches_pallas_formula(env16, g2):  # noqa: F811
    p, q, *_ = special_lanes(g2, 10, random.Random(86 + g2))
    out, exc = hf.addx_plain(g2, _port(p, 3), _port(q, 3))
    jout, jexc = env16["pf"]._jac_addx(_emitter(env16, g2), _jax_cols(p, 3, g2, env16),
                                       _jax_cols(q, 3, g2, env16))
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    assert exc.tolist() == [int(bool(x)) for x in np.asarray(jexc)]
    assert exc.tolist()[: len(ADDX_EXC)] == ADDX_EXC and not any(exc.tolist()[len(ADDX_EXC):])
    assert not out[2][3].any() and not out[2][4].any() and not out[2][5].any()  # h = 0 lanes: z3 = 0
    # the coordinates are the distinct add's; the CPU wrapper is the plain version
    assert all(torch.equal(a, b) for a, b in zip(out, hf.add_distinct_plain(g2, _port(p, 3), _port(q, 3))))
    wout, wexc = (hf.g2_addx if g2 else hf.g1_addx)(_port(p, 3), _port(q, 3))
    assert all(torch.equal(a, b) for a, b in zip(wout, out)) and torch.equal(wexc, exc)
