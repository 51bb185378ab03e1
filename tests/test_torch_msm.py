"""The port's scheduled MSM against the JAX package and the native host MSM.

Host half: the port's schedules (native two-pass scheduler and the numpy
path) equal the JAX ``build_schedule_multi``'s on the same limbs.  Device
half, with the plain kernels on CPU at small w and scalar_bits (as
tests/_msm_sched_check.py sizes them): the scheduled MSM equals
``native_bridge.msm`` for G1 and G2 and the JAX ``_msm_device`` for G1,
with uniform scalars, 0/1-skewed scalars that spill into orphan lanes and
(0, 0) points; a forced doubling corner takes the var-base fallback.  Exact
equality throughout.
"""

import inspect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vote_saver_tpu import native_bridge as nb
from vote_saver_tpu.ops import msm as jmsm
from vote_saver_tpu.ops import msm_sched as jms
from vote_saver_tpu.params import R
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm as tmsm
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _sched_fields(s):
    return (s.codes, s.merge_part, s.merge_gather, s.window_bits, s.num_windows, s.lanes,
            s.total_entries, s.num_parts)


def _assert_same_schedule(a, b):
    for x, y in zip(_sched_fields(a), _sched_fields(b)):
        if isinstance(x, np.ndarray):
            assert x.shape == y.shape and np.array_equal(x, y)
        else:
            assert x == y


def _scalars(kind, n, rnd, bits=256):
    if kind == "uniform":
        return [rnd.randrange(1 << bits) % R for _ in range(n)]
    # witness-like skew: mostly 0/1 wires (one hot bucket) plus a few wide
    return [rnd.choice((0, 1, 1, 1)) if i % 7 else rnd.randrange(1 << bits) % R for i in range(n)]


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_native_schedule_matches_jax(kind):
    assert nb.available()
    rnd = random.Random(1)
    n, parts = 300, 3
    limbs = [lb.ints_to_limbs(_scalars(kind, n, rnd), lb.FR) for _ in range(parts)]
    inf_mask = np.array([i % 37 == 5 for i in range(n)])
    got = ms.build_schedule_multi(limbs, 6, inf_mask)
    exp = jms.build_schedule_multi([x.astype(np.uint64) for x in limbs], 6, inf_mask)
    _assert_same_schedule(got, exp)
    if kind == "skewed":
        assert got.merge_gather.any(), "skewed scalars must spill into orphan lanes"
    # the scheduler also takes the limbs as device tensors
    _assert_same_schedule(ms.build_schedule_multi([lb.to_tensor(x) for x in limbs], 6, inf_mask), got)


def test_numpy_schedule_matches_jax(monkeypatch):
    """The digit path (small scalar_bits; the native pass needs 256 bits)."""
    rnd = random.Random(2)
    scalars = _scalars("skewed", 90, rnd, bits=20)
    got = ms.build_schedule(scalars, 5, None, scalar_bits=20)
    monkeypatch.setenv("VSTPU_SCHED", "python")
    exp = jms.build_schedule(scalars, 5, None, scalar_bits=20)
    _assert_same_schedule(got, exp)
    assert np.array_equal(ms.signed_digits(scalars, 5, scalar_bits=20),
                          jms.signed_digits(scalars, 5, scalar_bits=20))


def _points(g2, n, rnd):
    gen, group = (rc.g2_gen, "g2") if g2 else (rc.g1_gen, "g1")
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(n)])
    pts[3] = None  # a CRS point at infinity: (0, 0) on the device
    return pts


@pytest.mark.parametrize(
    "g2,kind,vs_jax",
    [(False, "uniform", True), (False, "skewed", False), (True, "uniform", False), (True, "skewed", False)],
    ids=["g1-uniform", "g1-skewed", "g2-uniform", "g2-skewed"],
)
def test_scheduled_msm_matches_native_and_jax(g2, kind, vs_jax):
    """Every case against the native MSM; the G1 uniform case also against
    the JAX scheduled MSM on the same schedule (its eager CPU run costs
    ~40 s for G1 and ~150 s for G2, so the other cases rest on the native
    MSM, which the JAX one is itself tested against)."""
    rnd = random.Random(3 + g2)
    group = "g2" if g2 else "g1"
    n = 40 if kind == "skewed" else 12
    pts = _points(g2, n, rnd)
    scalars = _scalars(kind, n, rnd, bits=20)
    if kind == "skewed":
        scalars = [1 if s else 0 for s in scalars]  # one hot bucket -> orphan runs
    inf_mask = np.array([p is None for p in pts])
    sched = ms.build_schedule(scalars, 5, inf_mask, scalar_bits=20)
    if kind == "skewed":
        assert sched.merge_gather.any()
    to_dev = ms.g2_affine_to_device if g2 else ms.g1_affine_to_device
    res, exc = ms.msm_device(group, to_dev(pts), sched)
    assert not bool(exc)
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    got = from_dev(res)[0]
    assert got == nb.msm(pts, scalars, group=group)
    if not vs_jax:
        return
    # the JAX scheduled MSM on the same schedule (its 32-bit CPU arm)
    jxy = tuple(jnp.asarray(convert.to_jax_limbs(c, 32)) for c in to_dev(pts))
    jres, jexc = jms._msm_device(group, jxy, jnp.asarray(sched.codes), jnp.asarray(sched.merge_part),
                                 jnp.asarray(sched.merge_gather), sched.num_windows, sched.window_bits)
    assert not bool(jexc)
    assert from_dev(tuple(convert.from_jax_limbs(np.asarray(c)) for c in jres))[0] == got


def test_doubling_corner_takes_var_base_fallback():
    rnd = random.Random(5)
    p = rc.g1_mul(rc.g1_gen, rnd.randrange(1, R))
    pts, scalars = [p, p], [3, 3]  # bucket 3 lifts p, then madds p again
    sched = ms.build_schedule(scalars, 5, None, scalar_bits=10)
    pxy = ms.g1_affine_to_device(pts)
    _res, exc = ms.msm_device("g1", pxy, sched)
    assert bool(exc), "the doubling corner must raise the exc flag"
    taken = []

    def fallback():
        taken.append(True)
        return ms.var_base_fallback("g1", pts, scalars, pxy[0].device)()

    res = ms.msm_scheduled("g1", pxy, sched, fallback=fallback)
    assert taken and co.g1_from_device(res) == [rc.g1_mul(p, 6)]
    with pytest.raises(RuntimeError):
        ms.msm_scheduled("g1", pxy, sched)


def test_var_base_fallback_runs_on_the_device_it_is_given():
    """The fallback has no default device (it used to default to the CPU,
    so on the card a scheduled MSM's fallback quietly returned a CPU
    result): its result lies on the device the caller names."""
    assert inspect.signature(ms.var_base_fallback).parameters["device"].default is inspect.Parameter.empty
    rnd = random.Random(7)
    pts = [rc.g1_mul(rc.g1_gen, rnd.randrange(1, R)) for _ in range(3)]
    for device in ("cpu", torch.device("cpu")):
        res = ms.var_base_fallback("g1", pts, [5, 0, 7], device)()
        assert all(c.device == torch.device(device) for c in res)
        assert co.g1_from_device(res) == [rj.msm_host(pts, [5, 0, 7])]


def test_var_base_msm_batches_parts():
    """msm_var_base over (parts, n) digits, as the prover's fallback runs it."""
    rnd = random.Random(6)
    pts = [rc.g1_mul(rc.g1_gen, rnd.randrange(1, R)) for _ in range(3)]
    scalars = [[rnd.randrange(1 << 16) for _ in pts] for _ in range(2)]
    limbs = torch.stack([lb.to_tensor(lb.ints_to_limbs(s, lb.FR)) for s in scalars])
    digits = tmsm.limbs_to_window_digits(limbs)[..., :4]  # 16-bit scalars: 4 windows
    assert torch.equal(tmsm.limbs_to_window_digits(limbs),
                       torch.from_numpy(np.array(jmsm.limbs_to_window_digits(
                           jnp.asarray(limbs.numpy().view(np.uint32).astype(np.uint64))))))
    res = tmsm.msm_var_base(co.g1_ops(), co.g1_to_device(pts), digits)
    assert co.g1_from_device(res) == [rj.msm_host(pts, s) for s in scalars]
