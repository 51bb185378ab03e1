"""The chain kernels: K1's Fermat inversion in one launch, K4 with a count.

  * ``FieldOps.inv`` (``hopper_field.mont_inv``; its plain version on CPU
    tensors) against the JAX package's ``FieldOps.inv`` (a ``lax.scan`` of
    K1 calls, 32-bit CPU-rig layout) and ``pow(a, N - 2, N)``, in Fq and Fr,
    at shapes (16,) and (3, 5);
  * ``mont_inv_plain`` against the chain of ``mont_mul_plain`` calls that
    ``FieldOps.inv`` used to run, one step at a time;
  * ``JacobianOps.double(p, times=k)`` against k single doublings and the
    Pallas formula ``_jac_double`` applied k times (run eagerly on CPU in the
    16-bit layout through the ``env16`` fixture), on the special lanes,
    canonical infinity included;
  * ``scalar_mul_windowed`` and ``combination_phase``, whose doubling runs
    are now one K4 launch each, against the same code with one doubling per
    call, and against the host oracle;
  * ``EdwardsOps.add`` with its products stacked into three K1 launches
    against the nine-multiply formula.

Every comparison is exact (integer arithmetic: tolerance zero).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _emitter, _from_jax, _jax_cols, _port, env16  # noqa: F401
from vote_saver_tpu.ops import field_ops as jfo
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch import native_bridge as nb
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import field_ops as tfo
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.params import Q, R
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.testing import special_lanes, torch_threads

FIELDS = {"fr": (R, lb.FR, tfo.fr_ops, jfo.fr_ops), "fq": (Q, lb.FQ, tfo.fq_ops, jfo.fq_ops)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _inv_inputs(N: int, spec, shape, seed: int):
    """Ints 0, 1, N - 1, R mod N, then random, in `shape`."""
    rnd = random.Random(seed)
    n = int(np.prod(shape))
    xs = [0, 1, N - 1, spec.mont_r % N] + [rnd.randrange(N) for _ in range(n - 4)]
    return xs, lb.ints_to_tensor(xs, spec).reshape(tuple(shape) + (spec.num_limbs,))


@pytest.mark.parametrize("shape", [(16,), (3, 5)], ids=["16", "3x5"])
@pytest.mark.parametrize("name", ["fr", "fq"])
def test_inv_matches_jax_and_pow(name, shape):
    N, spec, tops, jops = FIELDS[name]
    xs, a = _inv_inputs(N, spec, shape, 1 + len(shape))
    before = dict(hf.launches)
    got = tops().inv(a)
    assert hf.launches == before  # a CPU tensor runs the plain version: no launch
    assert got.shape == a.shape and got.dtype == torch.int32
    assert list(lb.tensor_to_ints(got.reshape(-1, spec.num_limbs), spec)) == [pow(x, N - 2, N) for x in xs]
    jgot = jops().inv(jnp.asarray(convert.to_jax_limbs(a, 32)))
    assert torch.equal(got, convert.from_jax_limbs(np.asarray(jgot)))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_inv_plain_is_the_mul_chain(name):
    """The plain version equals the chain of single K1 multiplies from one,
    MSB first over the bits of N - 2, as FieldOps.inv ran it before."""
    N, spec, *_ = FIELDS[name]
    xs, a = _inv_inputs(N, spec, (6,), 7)
    res = lb.ints_to_tensor([1] * len(xs), spec)
    for bit in hf.inv_bits(name):
        res = hf.mont_mul_plain(name, res, res)
        if bit:
            res = hf.mont_mul_plain(name, res, a)
    assert torch.equal(hf.mont_inv_plain(name, a), res)
    assert torch.equal(hf.mont_inv(name, a), res)
    assert hf.inv_bits(name)[0] == 1 and int("".join(map(str, hf.inv_bits(name))), 2) == N - 2


def _single_doublings(ops, p, k: int):
    for _ in range(k):
        p = ops.double(p)
    return p


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_double_times_rejects_a_bad_count(g2):
    p, *_ = special_lanes(g2, 8, random.Random(50 + g2))
    ops = co.g2_ops() if g2 else co.g1_ops()
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError):
            ops.double(_port(p, 3), times=bad)


def _old_scalar_mul_windowed(ops, p, digits, window: int = 4):
    """scalar_mul_windowed as it ran before K4 took a count: `window`
    separate doublings per digit."""
    entries = [ops.infinity_like(p[0]), p]
    for _ in range((1 << window) - 2):
        entries.append(ops.add(entries[-1], p))
    table = tuple(torch.stack([e[k] for e in entries]) for k in range(3))
    acc = ops.infinity_like(p[0])
    for w in range(digits.shape[-1] - 1, -1, -1):
        acc = _single_doublings(ops, acc, window)
        idx = digits[..., w].reshape((1, -1) + (1,) * ops.tail).expand((1,) + tuple(table[0].shape[1:]))
        acc = ops.add(acc, tuple(torch.gather(t, 0, idx)[0] for t in table))
    return acc


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_scalar_mul_windowed_same_limbs_as_single_doublings(g2):
    rnd = random.Random(60 + g2)
    group, gen = ("g2", rc.g2_gen) if g2 else ("g1", rc.g1_gen)
    n = 2 if g2 else 4
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(n)])
    ks = [rnd.randrange(1 << 20) for _ in range(n)]
    ks[0] = 0
    digits = torch.tensor([[(k >> (4 * w)) & 15 for w in range(5)] for k in ks])
    ops = co.g2_ops() if g2 else co.g1_ops()
    dev = (co.g2_to_device if g2 else co.g1_to_device)(pts)
    got = ops.scalar_mul_windowed(dev, digits)
    assert all(torch.equal(a, b) for a, b in zip(got, _old_scalar_mul_windowed(ops, dev, digits)))
    mul = rc.g2_mul if g2 else rc.g1_mul
    assert (co.g2_from_device if g2 else co.g1_from_device)(got) == [mul(p, k) for p, k in zip(pts, ks)]


def _old_horner(ops, addx, window_sums, w: int, parts: int, top: int):
    """_horner as it ran before K4 took a count: w separate doublings per
    window."""
    coords = tuple(c.reshape((parts, c.shape[0] // parts) + tuple(c.shape[1:])) for c in window_sums)
    acc = ops.infinity_like(coords[0][:, 0])
    for j in range(top, -1, -1):
        acc, _flag = addx(_single_doublings(ops, acc, w), tuple(c[:, j] for c in coords))
    return acc


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_combination_phase_same_limbs_as_single_doublings(g2):
    rnd = random.Random(70 + g2)
    group, gen = ("g2", rc.g2_gen) if g2 else ("g1", rc.g1_gen)
    n = 10 if g2 else 24
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(n)])
    scalars = [rnd.randrange(1, 1 << 12) for _ in range(n)]
    sched = ms.build_schedule(scalars, 4, None, scalar_bits=12)
    to_dev = ms.g2_affine_to_device if g2 else ms.g1_affine_to_device
    buckets, bexc = ms.bucket_phase(group, to_dev(pts), sched)
    assert not bool(bexc)
    ops, addx = ms._ops(group), ms._addx(group)
    got, exc = ms.combination_phase(group, buckets, sched, addx)
    assert exc is None
    sums, _ = ms._suffix_and_total(ops, addx, buckets, sched.num_windows * sched.num_parts,
                                   1 << (sched.window_bits - 1))
    old = _old_horner(ops, addx, sums, sched.window_bits, sched.num_parts, ms._top_window(sched))
    assert all(torch.equal(a, b) for a, b in zip(got, old))
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    assert from_dev(got) == [nb.msm(pts, scalars, group=group)]


def test_edwards_add_matches_the_nine_multiply_formula():
    """The stacked add gives the limbs of the formula with one K1 call per
    product, on random window points and the identity."""
    jj, f = co.jj_ops(), tfo.fr_ops()
    rnd = random.Random(80)
    vals = [[rnd.randrange(R) for _ in range(4)] for _ in range(6)]
    vals[0] = [0, 1, 1, 0]
    p = tuple(lb.ints_to_tensor([v[k] for v in vals], lb.FR) for k in range(4))
    q = tuple(torch.roll(c, 1, dims=0) for c in p)
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = f.mul(f.sub(y1, x1), f.sub(y2, x2))
    b = f.mul(f.add(y1, x1), f.add(y2, x2))
    c = f.mul(f.mul(t1, t2), jj.k2d)
    d = f.mul(z1, z2)
    d = f.add(d, d)
    e, ff, g, h = f.sub(b, a), f.sub(d, c), f.add(d, c), f.add(b, a)
    want = (f.mul(e, ff), f.mul(g, h), f.mul(ff, g), f.mul(e, h))
    assert all(torch.equal(x, y) for x, y in zip(jj.add(p, q), want))
    # broadcast operands, as the prefix scan's identity partners may come
    got = jj.add(p, tuple(c[:1] for c in q))
    assert all(torch.equal(x, y) for x, y in zip(got, jj.add(p, tuple(c[:1].expand_as(c) for c in q))))


_JAX_DOUBLINGS: dict = {}


def _jax_doublings(g2: bool, env):
    """The special lanes and the Pallas formula applied to them 10 times:
    every intermediate result in the port's layout (computed once per
    group, for every k)."""
    if g2 not in _JAX_DOUBLINGS:
        p, *_ = special_lanes(g2, 8, random.Random(90 + g2))
        cols = _jax_cols(p, 3, g2, env)
        steps = []
        for _ in range(10):
            cols = env["pf"]._jac_double(_emitter(env, g2), cols)
            steps.append(tuple(_from_jax(c, g2) for c in cols))
        _JAX_DOUBLINGS[g2] = (p, steps)
    return _JAX_DOUBLINGS[g2]


# the emitter tests swap the JAX modules for 16-bit copies: they run last
@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_double_times_matches_single_doublings_and_jax(env16, g2, k):  # noqa: F811
    p, jax_steps = _jax_doublings(g2, env16)
    ops = co.g2_ops() if g2 else co.g1_ops()
    P = _port(p, 3)
    got = ops.double(P, times=k)
    assert all(torch.equal(a, b) for a, b in zip(got, _single_doublings(ops, P, k)))
    assert all(torch.equal(a, b) for a, b in zip(got, jax_steps[k - 1]))
    assert all(torch.equal(a, b) for a, b in zip(got, hf.double_plain(g2, P, k)))
    one = lb.ints_to_tensor([(1, 0)] if g2 else [1], lb.FQ)[0]
    # lane 0 is canonical infinity (1, 1, 0): k doublings keep it
    assert torch.equal(got[0][0], one) and torch.equal(got[1][0], one) and not got[2][0].any()
