"""The port's CUDA kernels and device path on the card (skipped without one).

This file imports neither jax nor the JAX package's jax-bound modules, so it
also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel (K1 in Fq and Fr, K2-K4 in G1 and G2) must equal its plain
PyTorch version limb for limb on the special lanes of
``vote_saver_tpu_torch.testing``; a scheduled MSM must equal the native host
MSM; a proof made on the card must be byte-identical to the same proof made
by the plain versions on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from vote_saver_tpu import native_bridge as nb
from vote_saver_tpu.circuit.r1cs import ConstraintSystem, lc
from vote_saver_tpu.params import Q, R
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.protocol import groth16 as tg
from vote_saver_tpu_torch.testing import MADD_EXC, special_lanes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, decided at run time (never at import): skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("name,N", [("fq", Q), ("fr", R)])
def test_k1_matches_plain(dev, name, N):
    rnd = random.Random(1)
    xs = [0, 1, N - 1, N - 1] + [rnd.randrange(N) for _ in range(4092)]
    ys = [N - 1, 1, N - 1, 0] + [rnd.randrange(N) for _ in range(4092)]
    spec = lb.spec_for(name)
    a, b = lb.ints_to_tensor(xs, spec, dev), lb.ints_to_tensor(ys, spec, dev)
    before = hf.launches[f"mont_mul_{name}"]
    got = hf.mont_mul(name, a, b)
    assert hf.launches[f"mont_mul_{name}"] == before + 1
    assert torch.equal(got, hf.mont_mul_plain(name, a, b))
    assert list(lb.tensor_to_ints(got, spec)) == [x * y % N for x, y in zip(xs, ys)]
    # broadcasting operands, as the NTT passes its twiddles
    assert torch.equal(hf.mont_mul(name, a.reshape(64, 64, -1), b[:64]),
                       hf.mont_mul_plain(name, a.reshape(64, 64, -1), b[:64]))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_curve_kernels_match_plain(dev, g2):
    p, q, acc, qm, sign, active = special_lanes(g2, 1024, random.Random(2 + g2))

    def put(points, k):
        return tuple(lb.ints_to_tensor([pt[i] for pt in points], lb.FQ, dev) for i in range(k))

    P, Qd, A, QA = put(p, 3), put(q, 3), put(acc, 3), put(qm, 2)
    S, ACT = torch.tensor(sign, device=dev), torch.tensor(active, device=dev)
    madd, add, dbl = (hf.g2_madd, hf.g2_add, hf.g2_double) if g2 else (hf.g1_madd, hf.g1_add, hf.g1_double)
    (mo, me), (po, pe) = madd(A, QA, S, ACT), hf.madd_plain(g2, A, QA, S, ACT)
    assert all(torch.equal(x, y) for x, y in zip(mo, po)) and torch.equal(me, pe)
    assert me[: len(MADD_EXC)].tolist() == MADD_EXC
    assert all(torch.equal(x, y) for x, y in zip(add(P, Qd), hf.add_plain(g2, P, Qd)))
    assert all(torch.equal(x, y) for x, y in zip(dbl(P), hf.double_plain(g2, P)))
    # in place, as the bucket scan runs it
    out, exc = madd(A, QA, S, ACT, out=tuple(c.clone() for c in A))
    assert all(torch.equal(x, y) for x, y in zip(out, mo)) and torch.equal(exc, me)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_scheduled_msm_matches_native(dev, g2):
    rnd = random.Random(4 + g2)
    group = "g2" if g2 else "g1"
    gen = rc.g2_gen if g2 else rc.g1_gen
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(512)])
    pts[7] = None
    scalars = [rnd.randrange(R) if i % 5 else rnd.choice((0, 1)) for i in range(512)]
    sched = ms.build_schedule(scalars, 8, np.array([p is None for p in pts]))
    to_dev = ms.g2_affine_to_device if g2 else ms.g1_affine_to_device
    res, exc = ms.msm_device(group, to_dev(pts, dev), sched)
    assert not bool(exc)
    assert (co.g2_from_device if g2 else co.g1_from_device)(res) == [nb.msm(pts, scalars, group=group)]


def test_prove_on_card_matches_cpu(dev):
    """A toy Groth16 proof on the card is byte-identical to the plain one."""
    cs = ConstraintSystem()
    out = cs.alloc()
    cs.set_input_sizes(1)
    xs, ps = cs.alloc_vec(8), cs.alloc_vec(8)
    prev = 0
    for x, p in zip(xs, ps):
        cs.constrain(lc((x, 1)), lc((x, 1)), lc((x, 1)))
        cs.constrain(lc((prev, 1)), lc((x, 1), (0, 1)), lc((p, 1)))
        prev = p
    cs.constrain(lc((prev, 1)), lc((0, 1)), lc((out, 1)))
    w = np.zeros((2, cs.num_vars), dtype=object)
    w[:, 0] = 1
    for b, bits in enumerate(([1, 0] * 4, [1, 1, 0, 0] * 2)):
        acc = 1
        for k, bit in enumerate(bits):
            acc = acc * (bit + 1) % R
            w[b, xs[k]], w[b, ps[k]] = bit, acc
        w[b, out] = acc
    assert cs.is_satisfied(w)
    pk, vk = tg.setup(cs, FrRandom(3))
    on_card = tg.prove(pk, w, FrRandom(4), dev, window_bits=4)
    on_cpu = tg.prove(pk, w, FrRandom(4), "cpu", window_bits=4)
    assert [M.ser_proof(p) for p in on_card] == [M.ser_proof(p) for p in on_cpu]
    assert all(tg.verify(vk, [int(w[i, 1])], p) for i, p in enumerate(on_card))
