"""The port's CUDA kernels and device path on the card (skipped without one).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel (K1 in Fq and Fr in each multiplier mode and as the Fermat
inversion, K2-K4, K4 with a count of doublings, K2's bucket scan, K3's
suffix round, K3d and K5/K6 in G1 and G2, K3d as setup's window sum in
every mode and team size at 2048 and 2^16 outputs, K3 in G2 as a team of
threads a lane at ragged widths, K1 with an operand broadcast over the batch at
the vote path's shapes) must equal its plain PyTorch version limb for limb
on the special lanes of ``vote_saver_tpu_torch.testing``, in one launch per
call (the team kernel with no spill); a scheduled MSM,
through one scan launch and the suffix rounds' shift form, must equal the
native host MSM, and so must a G2 MSM's buckets combined through the flagged
distinct add K6; the probes K7-K10 must pass their host-oracle
parity, the tensor-core fold of K7 and K10, the PTX carry chains of K7 and
K8 and K7's yardstick instances must equal their plain versions at ragged
lane counts; a proof made on the card must be byte-identical to the same proof
made by the plain versions on the CPU; setup on the card must write the
host-native arm's CRS; the int8 matmul NTT must equal the radix-2 path on
the card for each of its four kinds.  The curve kernels and the inversion
chain in the v1 and fold multiplier modes must equal the same plain
versions, each launch counted under its mode's instance; a fold launch
must find its unit's matrix in place; the fold bucket scans, suffix
rounds and doublings of G1 and G2, whose fold product runs on the tensor
cores, must equal their plain versions at 1 to 2^14 lanes, the scans at
the vote path's h schedule (G1 80 rows, G2 32) and G2's at ragged widths,
the suffix rounds on the vote path's 432 x 512 grid at shifts 1 to 256
and on a ragged grid of bw = 16 at every shift, the G2 doubling at the
vote path's widths and counts, the G1 complete add (a block's four warps
sharing one 32-lane add) at 1 to 2^14 lanes with blocks whose only
doubling lane is one of 32, and the Fr inversion chain (its Fr fold on
the tensor cores) at 1 to 2^16 lanes with 0, 1 and r - 1 among them, and
a launch of each must find its B operand in place; and a depth-2 vote under
``VSTPU_MUL=v1`` or ``=fold`` must launch only that mode's instances and
give the golden ballots.
"""

import json
import os
import pathlib
import pickle
import random

import numpy as np
import pytest
import torch

from vote_saver_tpu_torch import micro
from vote_saver_tpu_torch import native_bridge as nb
from vote_saver_tpu_torch.circuit.r1cs import ConstraintSystem, lc
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import fold_mul
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.params import Q, R
from vote_saver_tpu_torch.protocol import groth16 as tg
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.testing import (ADDX_EXC, MADD_EXC, SCAN_EXC, scan_lanes, shift_grid, special_lanes,
                                          team_add_lanes, window_scalars)
from vote_saver_tpu_torch.utils.rng import FrRandom

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


@pytest.mark.parametrize("lanes", [1, 16, 17, 32, 33, 1 << 14])
def test_team_g2_add_matches_plain(dev, lanes):
    """K3 in G2 as a team of 16 threads a lane, ragged lane counts and the
    special lanes (testing.team_add_lanes) included, one launch a call."""
    p, q = team_add_lanes(True, lanes, random.Random(lanes))
    P, Qd = (tuple(lb.ints_to_tensor([pt[i] for pt in pts], lb.FQ, dev) for i in range(3)) for pts in (p, q))
    before = hf.launches["g2_add"]
    got = hf.g2_add(P, Qd)
    assert hf.launches["g2_add"] == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, hf.add_plain(True, P, Qd)))


def test_team_kernel_does_not_spill(dev):
    from vote_saver_tpu_torch.ops import _build

    usage = {name: (regs, spill) for name, regs, spill in _build.resource_lines(_build.load().resource_usage)}
    regs, spill = usage["k_add_team<AddTeamG2,MulLoop>"]
    assert spill == 0 and regs < 128, usage["k_add_team<AddTeamG2,MulLoop>"]


# K1 in Fr at the vote path's large shapes (a's and b's leading dims): the
# COO products (the coefficient table first), H against zh_coset_inv,
# from_mont's constant, the matmul NTT's twiddle, the R1CS check
K1_PATH_SHAPES = [((1, 41007), (16, 41007)), ((16, 1 << 15), (1 << 15,)), ((16, 1 << 15), ()),
                  ((16, 256, 128), (256, 128)), ((16, 1 << 15), (16, 1 << 15))]


@pytest.mark.parametrize("sa,sb", K1_PATH_SHAPES)
def test_k1_broadcast_operand_matches_materialized(dev, sa, sb):
    gen = torch.Generator(device=dev).manual_seed(len(sa) * 100 + len(sb))

    def limbs(shape):
        n = 1
        for d in shape:
            n *= d
        return micro.random_limbs("fr", n, dev, gen).reshape(tuple(shape) + (8,))

    a, b = limbs(sa), limbs(sb)
    full = tuple(t.contiguous() for t in torch.broadcast_tensors(a, b))
    before = hf.launches["mont_mul_fr"]
    got = hf.mont_mul("fr", a, b)
    assert hf.launches["mont_mul_fr"] == before + 1
    assert torch.equal(got, hf.mont_mul("fr", *full))
    assert torch.equal(got, hf.mont_mul_plain("fr", *full))


@pytest.mark.parametrize("name,N", [("fq", Q), ("fr", R)])
def test_mont_inv_matches_plain(dev, name, N):
    """The Fermat chain in one launch, at the device witness's 16 lanes and
    at 2^16 lanes."""
    spec = lb.spec_for(name)
    rnd = random.Random(10)
    for lanes in (16, 1 << 16):
        xs = [0, 1, N - 1, spec.mont_r % N] + [rnd.randrange(N) for _ in range(lanes - 4)]
        a = lb.ints_to_tensor(xs, spec, dev)
        before = hf.launches[f"mont_inv_{name}"]
        got = hf.mont_inv(name, a)
        assert hf.launches[f"mont_inv_{name}"] == before + 1
        assert torch.equal(got, hf.mont_inv_plain(name, a))
        assert list(lb.tensor_to_ints(got[:64], spec)) == [pow(x, N - 2, N) for x in xs[:64]]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_double_times_matches_plain(dev, g2):
    """Ten doublings in one launch: the plain version's ten formulas and ten
    single launches, canonical infinity (lane 0) included."""
    p, *_ = special_lanes(g2, 480, random.Random(11 + g2))
    P = tuple(lb.ints_to_tensor([pt[i] for pt in p], lb.FQ, dev) for i in range(3))
    dbl = hf.g2_double if g2 else hf.g1_double
    name = "g2_double" if g2 else "g1_double"
    before = hf.launches[name]
    got = dbl(P, times=10)
    assert hf.launches[name] == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, hf.double_plain(g2, P, 10)))
    single = P
    for _ in range(10):
        single = dbl(single)
    assert all(torch.equal(x, y) for x, y in zip(got, single))
    assert not got[2][0].any()


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_add_distinct_matches_plain(dev, g2):
    p, q, *_ = special_lanes(g2, 1024, random.Random(5 + g2))
    P, Qd = (tuple(lb.ints_to_tensor([pt[i] for pt in pts], lb.FQ, dev) for i in range(3)) for pts in (p, q))
    name = "g2_add_distinct" if g2 else "g1_add_distinct"
    before = hf.launches[name]
    got = (hf.g2_add_distinct if g2 else hf.g1_add_distinct)(P, Qd)
    assert hf.launches[name] == before + 1
    exp = hf.add_distinct_plain(g2, P, Qd)
    assert all(torch.equal(x, y) for x, y in zip(got, exp))
    assert not got[2][3].any() and not got[2][4].any()  # h = 0 lanes: the formula's z3 = 0


@pytest.mark.parametrize("name,N", [("fq", Q), ("fr", R)])
def test_k1_modes_match_plain(dev, name, N):
    rnd = random.Random(7)
    spec = lb.spec_for(name)
    rinv = pow(spec.mont_r, -1, N)
    xs = [0, 1, N - 1, rinv, (N - 1) * rinv % N] + [rnd.randrange(N) for _ in range(4091)]
    ys = [N - 1, 1, N - 1, rinv, (N - 1) * rinv % N] + [rnd.randrange(N) for _ in range(4091)]
    a, b = lb.ints_to_tensor(xs, spec, dev), lb.ints_to_tensor(ys, spec, dev)
    loop = hf.mont_mul(name, a, b)
    for mode in ("v1", "fold"):
        key = f"mont_mul_{name}_{mode}"
        before = hf.launches[key]
        got = hf.mont_mul(name, a, b, mode)
        assert hf.launches[key] == before + 1
        assert torch.equal(got, loop) and torch.equal(got, hf.mont_mul_plain(name, a, b, mode)), mode
    assert list(lb.tensor_to_ints(loop, spec)) == [x * y % N for x, y in zip(xs, ys)]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_addx_matches_plain(dev, g2):
    p, q, *_ = special_lanes(g2, 1024, random.Random(8 + g2))
    P, Qd = (tuple(lb.ints_to_tensor([pt[i] for pt in pts], lb.FQ, dev) for i in range(3)) for pts in (p, q))
    name = "g2_addx" if g2 else "g1_addx"
    before = hf.launches[name]
    got, exc = (hf.g2_addx if g2 else hf.g1_addx)(P, Qd)
    assert hf.launches[name] == before + 1
    exp, pexc = hf.addx_plain(g2, P, Qd)
    assert all(torch.equal(x, y) for x, y in zip(got, exp)) and torch.equal(exc, pexc)
    assert exc[: len(ADDX_EXC)].tolist() == ADDX_EXC
    assert all(torch.equal(x, y) for x, y in zip(got, hf.add_distinct_plain(g2, P, Qd)))


def test_g2_combination_through_addx_matches_native(dev):
    """A G2 MSM's buckets combined by K6: equal to the native MSM and to the
    complete adder (every bucket below a window's top is non-empty)."""
    rnd = random.Random(9)
    pts = rj.FixedBaseHost(rc.g2_gen, "g2").mul_many([rnd.randrange(1, R) for _ in range(2048)])
    scalars = [rnd.randrange(R) for _ in range(2048)]
    sched = ms.build_schedule(scalars, 8)
    buckets, bexc = ms.bucket_phase("g2", ms.g2_affine_to_device(pts, dev), sched)
    before = hf.launches["g2_addx"]
    res, exc = ms.combination_phase("g2", buckets, sched, ms._addx("g2", distinct=True))
    assert hf.launches["g2_addx"] > before
    cres, cexc = ms.combination_phase("g2", buckets, sched, ms._addx("g2"))
    assert not bool(bexc) and not bool(exc) and not bool(cexc)
    assert all(torch.equal(x, y) for x, y in zip(res, cres))
    assert co.g2_from_device(res) == [nb.msm(pts, scalars, group="g2")]


def test_probes_pass_parity(dev):
    """K7-K10 and K1 by mode at reduced widths: host-oracle parity, kernel
    equal to plain."""
    for mode in hf.MODES:
        assert micro.field_mul(mode, dev, lanes=1 << 14, reps=2)["max_abs_err"] == 0
    for mode in micro.YARDSTICKS:
        assert micro.yardstick(mode, dev, lanes=1 << 14, reps=2)["max_abs_err"] == 0
    assert all(r["max_abs_err"] == 0 for r in micro.mul_chain(device=dev, lanes=1 << 14, reps=2).values())
    assert all(r["max_abs_err"] == 0 for r in micro.op_throughput(dev, lanes=1 << 14, reps=2).values())
    assert all(r["parity"] for r in micro.mont_mul_modes(dev, lanes=1 << 14, reps=2).values())


@pytest.mark.parametrize("lanes", [1, 33, micro.PARITY_LANES + 5])
@pytest.mark.parametrize("probe", ["k7_fold", "k10_fold"])
def test_fold_chains_match_plain_at_ragged_lanes(dev, probe, lanes):
    """K7 and K10 fold (the fold product on the tensor cores, a warp's 32
    lanes as one tile) at lane counts that leave a warp or a block part
    full: one launch, every lane equal to the plain version (K7's chains
    1.. starting along the lane's row of 128, as bench.py's probe rolls
    them), chain 0 equal to x (y R^-1)^depth on sampled lanes; lane 0 has
    every digit 255."""
    _idx, mode, chains, unroll, _mul = micro.CHAIN_PROBES[probe]
    gen = torch.Generator(device=dev).manual_seed(lanes)
    x, y = micro.random_limbs("fq", lanes, dev, gen), micro.random_limbs("fq", lanes, dev, gen)
    x[0], y[0] = -1, -1
    before = micro.launches[f"mul_chain_{probe}"]
    k0, k1 = micro.run_chain(probe, x, y)
    assert micro.launches[f"mul_chain_{probe}"] == before + 1
    p0, p1 = micro.mul_chain_plain(mode, chains, unroll, x, y, start=micro.start_of(probe))
    assert torch.equal(k0, p0) and (chains == 1 or torch.equal(k1, p1))
    idx = micro._check_lanes(lanes)
    xs, ys, got = (lb.tensor_to_ints(t[idx], lb.FQ, mont=False) for t in (x, y, k0))
    rinv = pow(lb.FQ.mont_r, -1, Q)
    assert list(got) == [int(a) * pow(int(b) * rinv % Q, unroll, Q) % Q for a, b in zip(xs, ys)]


@pytest.mark.parametrize("lanes", [1, 33, micro.PARITY_LANES + 5])
@pytest.mark.parametrize("probe", ["k7_loop", "k7_v1", "k8_loop", "k8_v1", "k7_loop_c64", "k7_v1_c64"])
def test_carry_chain_probes_match_plain(dev, probe, lanes):
    """K7 and K8 in loop and v1, the PTX carry chains, and K7's yardstick
    instances (the curve kernels' multiply) in one launch each at lane
    counts that leave a row of 128, a warp or a block part full: every lane
    of both outputs equal to the plain version.  Lane 0 is 2^384 - 1 (its
    K8 starts too), lane 1 Q - 1 against y = Q - 1; K8's starts of chains
    1.. are rotations, most of them >= Q."""
    _idx, mode, chains, unroll, _mul = micro.CHAIN_PROBES[probe]
    gen = torch.Generator(device=dev).manual_seed(lanes + 1)
    x, y = micro.random_limbs("fq", lanes, dev, gen), micro.random_limbs("fq", lanes, dev, gen)
    x[0] = -1
    if lanes > 1:
        x[1] = y[1] = lb.ints_to_tensor([Q - 1], lb.FQ, dev, mont=False)[0]
    before = micro.launches[f"mul_chain_{probe}"]
    k0, k1 = micro.run_chain(probe, x, y)
    torch.cuda.synchronize()
    assert micro.launches[f"mul_chain_{probe}"] == before + 1
    p0, p1 = micro.mul_chain_plain(mode, chains, unroll, x, y, start=micro.start_of(probe))
    assert torch.equal(k0, p0) and torch.equal(k1, p1)
    if probe.startswith("k8") and lanes > 33:
        assert sum(int(v >= Q) for s in micro.chain_starts("limbs", chains, x)[1:]
                   for v in lb.tensor_to_ints(s, lb.FQ, mont=False)) > lanes


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
    before = dict(hf.launches)
    res, exc = ms.msm_device(group, to_dev(pts, dev), sched)
    assert not bool(exc)
    assert (co.g2_from_device if g2 else co.g1_from_device)(res) == [nb.msm(pts, scalars, group=group)]
    # one scan launch, no single-row madd, and 2 x 7 suffix rounds (w = 8: 128 buckets a window)
    assert hf.launches[f"{group}_madd_scan"] == before[f"{group}_madd_scan"] + 1
    assert hf.launches[f"{group}_madd"] == before[f"{group}_madd"]
    assert hf.launches[f"{group}_add_shift"] == before[f"{group}_add_shift"] + 14


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
    pk, vk = tg.setup(cs, FrRandom(3), device="host")
    on_card = tg.prove(pk, w, FrRandom(4), dev, window_bits=4)
    on_cpu = tg.prove(pk, w, FrRandom(4), "cpu", window_bits=4)
    assert [M.ser_proof(p) for p in on_card] == [M.ser_proof(p) for p in on_cpu]
    assert all(tg.verify(vk, [int(w[i, 1])], p) for i, p in enumerate(on_card))


def test_one_cache_entry_per_card(dev):
    """"cuda" names the current card's index (limbs.device_of), so the
    device constants a long-lived proving key, the NTT plans, the Edwards
    ops and the Pedersen window tables cache are held once however the
    caller names the card."""
    from vote_saver_tpu_torch.ops import ntt as tntt
    from vote_saver_tpu_torch.ops import ntt_mxu
    from vote_saver_tpu_torch.ops import pedersen_ops as po

    cs = ConstraintSystem()
    out = cs.alloc()
    cs.set_input_sizes(1)
    x = cs.alloc()
    cs.constrain(lc((x, 1)), lc((x, 1)), lc((out, 1)))
    pk, _vk = tg.setup(cs, FrRandom(7), device="host")
    indexed = torch.device("cuda", torch.cuda.current_device())
    assert lb.device_of("cuda") == indexed
    assert tg.devaff(pk, "a", "cuda") is tg.devaff(pk, "a", indexed) is tg.devaff(pk, "a", str(indexed))
    assert [k for k in pk._dev if k[0] == "devaff"] == [("devaff", "a", str(indexed))]
    plan = ntt_mxu.get_plan(1 << 8, "inv")
    assert plan.table("t12", "cuda") is plan.table("t12", indexed)
    ntt = tntt.get_ntt(1 << 8, "radix2")
    assert ntt.table("zh_coset_inv", "cuda") is ntt.table("zh_coset_inv", indexed)
    # the Edwards 2d constant and the Pedersen window tables of the Merkle hash
    jj = co.jj_ops()
    assert jj._k2d("cuda") is jj._k2d(indexed) is jj._k2d(str(indexed))
    assert [k for k in jj._dev if k.type == "cuda"] == [indexed]
    assert po.window_tables(85, "cuda") is po.window_tables(85, indexed) is po.window_tables(85, str(indexed))
    assert [k for k in po._tables if k[0] == 85 and k[1].type == "cuda"] == [(85, indexed)]


def test_setup_on_card_matches_host(dev):
    """Setup through the device table on the card writes the host-native
    arm's CRS, byte for byte."""
    cs = ConstraintSystem()
    out = cs.alloc()
    cs.set_input_sizes(1)
    xs = cs.alloc_vec(40)
    for x in xs:
        cs.constrain(lc((x, 1)), lc((x, 1)), lc((x, 1)))
    cs.constrain(lc(*((x, 1) for x in xs)), lc((0, 1)), lc((out, 1)))
    hf.reset_launches()
    pk, vk = tg.setup(cs, FrRandom(6), device=dev)
    # each group's scalars in one window-sum launch, and no single distinct add
    assert {k: hf.launches[k] for k in ("g1_window_sum", "g2_window_sum", "g1_add_distinct", "g2_add_distinct")} == {
        "g1_window_sum": 1, "g2_window_sum": 1, "g1_add_distinct": 0, "g2_add_distinct": 0}
    hpk, hvk = tg.setup(cs, FrRandom(6), device="host")
    assert M.ser_groth16_pk(pk) == M.ser_groth16_pk(hpk) and M.ser_groth16_vk(vk) == M.ser_groth16_vk(hvk)


_WINDOW_PLAIN: dict = {}


def _window_case(g2: bool, dev):
    """(table on the card, 2048 digit rows of testing.window_scalars, their
    window_sum_plain), the plain version run once a group."""
    if g2 not in _WINDOW_PLAIN:
        tbl = msm.FixedBaseTable(rc.g2_gen if g2 else rc.g1_gen, "g2" if g2 else "g1")
        table = tuple(c.to(dev) for c in tbl.table)
        digits = torch.from_numpy(tbl.digits(window_scalars(2048, random.Random(30 + g2)))).to(dev)
        _WINDOW_PLAIN[g2] = table, digits, hf.window_sum_plain(g2, table, digits)
    return _WINDOW_PLAIN[g2]


@pytest.mark.parametrize("mode", hf.MODES)
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_window_sum_matches_plain(dev, g2, mode):
    """Setup's window sum in each mode, at every team size in loop (v1 and
    fold build only WINDOW_TEAM), one launch of the mode's instance a call, equal to window_sum_plain on the special
    rows (0, 1, R - 1, a zero low or high half, one nonzero window) at 2048
    outputs, and at 2^16: the 2048 rows drawn at random positions, so a
    lane that read another row would differ from the plain rows it draws."""
    table, digits, exp = _window_case(g2, dev)
    perm = torch.randint(0, digits.shape[0], (1 << 16,), generator=torch.Generator().manual_seed(31 + g2)).to(dev)
    wide = (digits[perm].contiguous(), tuple(c[perm] for c in exp))
    fn = hf.g2_window_sum if g2 else hf.g1_window_sum
    name = "g2_window_sum" if g2 else "g1_window_sum"
    teams = (1, 2, 4, 8) if mode == "loop" else (hf.WINDOW_TEAM,)
    for team in teams:
        for d, want in ((digits, exp), wide):
            got = _once(name, mode, lambda d=d, team=team: fn(table, d, mode=mode, team=team))
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (team, d.shape[0])
    for team in {1, 2, 4, 8} - set(teams):
        with pytest.raises(ValueError):
            fn(table, digits, mode=mode, team=team)
    with pytest.raises(IndexError):
        fn(table, torch.full_like(digits[:4], 256), mode=mode)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_madd_scan_matches_plain_and_the_row_loop(dev, g2):
    """The scan in one launch: its plain version, and the single-row kernel
    launched once per row, give the same limbs and flags; a code naming no
    point raises IndexError in both, before anything runs on the card."""
    pts, codes = scan_lanes(g2, 64, 1024, 16, random.Random(12 + g2))
    pxy = (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(pts, dev)
    c = torch.from_numpy(codes).to(dev)
    scan, madd = (hf.g2_madd_scan, hf.g2_madd) if g2 else (hf.g1_madd_scan, hf.g1_madd)
    name = "g2_madd_scan" if g2 else "g1_madd_scan"
    before = hf.launches[name]
    acc, exc = scan(pxy, c)
    assert hf.launches[name] == before + 1
    pacc, pexc = hf.madd_scan_plain(g2, pxy, c)
    assert all(torch.equal(x, y) for x, y in zip(acc, pacc)) and torch.equal(exc, pexc)
    assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC
    loop = (co.g2_ops() if g2 else co.g1_ops()).infinity_like(torch.zeros_like(acc[0]))
    lexc = torch.zeros_like(exc)
    for row in c:
        pidx = ((row & ((1 << 30) - 1)) - 1).clamp(min=0)
        loop, e = madd(loop, (pxy[0].index_select(0, pidx), pxy[1].index_select(0, pidx)),
                       ((row >> 30) & 1) != 0, row != 0, out=loop)
        lexc |= e
    assert all(torch.equal(x, y) for x, y in zip(acc, loop)) and torch.equal(exc, lexc)
    bad = c.clone()
    bad[3, 100] = len(pts) + 1
    with pytest.raises(IndexError):
        hf.madd_scan_plain(g2, pxy, bad)
    with pytest.raises(IndexError):
        scan(pxy, bad)
    assert hf.launches[name] == before + 1


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_add_shift_matches_plain(dev, g2):
    """One suffix round per launch over a 4 x 512 grid, at shifts below, at
    and above the window, with equal, opposite and infinite operands."""
    rows, bw = 4, 512
    pts = shift_grid(g2, rows, bw, random.Random(13 + g2))
    flat = tuple(lb.ints_to_tensor([pt[i] for pt in pts], lb.FQ, dev) for i in range(3))
    grid = tuple(c.reshape((rows, bw) + tuple(c.shape[1:])) for c in flat)
    add_shift = hf.g2_add_shift if g2 else hf.g1_add_shift
    name = "g2_add_shift" if g2 else "g1_add_shift"
    for shift in (1, 2, 4, 16, 256, 512, 700):
        before = hf.launches[name]
        got = add_shift(grid, shift)
        assert hf.launches[name] == before + 1
        assert all(torch.equal(x, y) for x, y in zip(got, hf.add_shift_plain(g2, grid, shift))), shift
    out = tuple(torch.empty_like(c) for c in grid)
    assert add_shift(grid, 8, out=out) is out
    with pytest.raises(ValueError):
        add_shift(grid, 1, out=grid)


@pytest.mark.parametrize("kind,ref", [("fwd", "ntt"), ("inv", "intt"), ("fwd_coset", "coset_ntt"),
                                      ("inv_coset", "coset_intt")])
def test_matmul_ntt_matches_radix2(dev, kind, ref):
    """The int8 matmul NTT at n = 2^12 (four rows, the first led by values
    that saturate digit columns and fold boundaries) equals the radix-2 path
    on the card and the int64 product form on the CPU: two ``_int_mm``
    products and two folds a transform, one K1 launch for the twiddle."""
    from vote_saver_tpu_torch.ops import ntt as tntt
    from vote_saver_tpu_torch.ops import ntt_mxu

    n = 1 << 12
    gen = torch.Generator(device=dev).manual_seed(12)
    x = micro.random_limbs("fr", 4 * n, dev, gen).reshape(4, n, 8)
    x[0, :8] = lb.ints_to_tensor([0, 1, R - 1, R - 2, (1 << 254) - 1, R - (1 << 200), 2, R // 2], lb.FR, dev)
    before, k1 = dict(ntt_mxu.products), hf.launches["mont_mul_fr"]
    got = getattr(tntt.get_ntt(n, "matmul"), ref)(x)
    torch.cuda.synchronize()
    assert {k: ntt_mxu.products[k] - before[k] for k in before} == {"step_a": 1, "step_c": 1, "fold": 2}
    assert hf.launches["mont_mul_fr"] == k1 + 1
    assert torch.equal(got, getattr(tntt.get_ntt(n, "radix2"), ref)(x))
    assert torch.equal(got.cpu(), ntt_mxu.get_plan(n, kind).apply(x.cpu(), "int64"))


def test_merkle_tree_on_card_matches_host(dev):
    """The depth-3 tree hashed on the card (one Pedersen call a level, K1 in
    Fr) is the oracle's, special rows included; a level's hash equals its
    plain version on the CPU."""
    from vote_saver_tpu_torch.ops import merkle
    from vote_saver_tpu_torch.ops import pedersen_ops as po

    leaves = np.random.default_rng(8).integers(0, 2, (8, 255)).astype(np.int32)
    leaves[0], leaves[1] = 0, 1
    hf.reset_launches()
    on_card = merkle.build_tree(leaves, dev)
    assert hf.launches["mont_mul_fr"] > 0 and hf.launches["mont_inv_fr"] == 4
    host = merkle.build_tree(leaves, "host")
    assert all(np.array_equal(a, b) for a, b in zip(on_card, host, strict=True))
    pairs = on_card[0].reshape(4, 510)
    assert torch.equal(po.pedersen_hash_bits(pairs, 510, dev).cpu(), po.pedersen_hash_bits(pairs, 510, "cpu"))


CURVE_MODES = ("v1", "fold")


def _put(points, k, dev):
    return tuple(lb.ints_to_tensor([pt[i] for pt in points], lb.FQ, dev) for i in range(k))


def _once(kernel: str, mode: str, fn):
    """fn() and a check that it launched `kernel`'s `mode` instance once
    and nothing else."""
    hf.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert {k: v for k, v in hf.launches.items() if v} == {hf.instance(kernel, mode): 1}, hf.launches
    return out


@pytest.mark.parametrize("mode", CURVE_MODES)
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_curve_mode_instances_match_plain(dev, g2, mode):
    """Every curve kernel's v1 / fold instance on the special lanes: K2
    (and in place), K3 (G2: the team, at ragged widths), K3d, K4 with a
    count, K5/K6, the bucket scan and the suffix round, each one launch of
    the mode's instance, equal to the plain version."""
    pre = "g2" if g2 else "g1"
    p, q, acc, qm, sign, active = special_lanes(g2, 1024, random.Random(20 + g2))
    P, Qd, A, QA = _put(p, 3, dev), _put(q, 3, dev), _put(acc, 3, dev), _put(qm, 2, dev)
    S, ACT = torch.tensor(sign, device=dev), torch.tensor(active, device=dev)
    madd = hf.g2_madd if g2 else hf.g1_madd
    (mo, me) = _once(f"{pre}_madd", mode, lambda: madd(A, QA, S, ACT, mode=mode))
    po, pe = hf.madd_plain(g2, A, QA, S, ACT)
    assert all(torch.equal(x, y) for x, y in zip(mo, po)) and torch.equal(me, pe)
    assert me[: len(MADD_EXC)].tolist() == MADD_EXC
    out, exc = _once(f"{pre}_madd", mode, lambda: madd(A, QA, S, ACT, out=tuple(c.clone() for c in A), mode=mode))
    assert all(torch.equal(x, y) for x, y in zip(out, mo)) and torch.equal(exc, me)
    add = hf.g2_add if g2 else hf.g1_add
    assert all(torch.equal(x, y) for x, y in zip(_once(f"{pre}_add", mode, lambda: add(P, Qd, mode=mode)),
                                                  hf.add_plain(g2, P, Qd)))
    addd = hf.g2_add_distinct if g2 else hf.g1_add_distinct
    assert all(torch.equal(x, y) for x, y in zip(
        _once(f"{pre}_add_distinct", mode, lambda: addd(P, Qd, mode=mode)), hf.add_distinct_plain(g2, P, Qd)))
    dbl = hf.g2_double if g2 else hf.g1_double
    assert all(torch.equal(x, y) for x, y in zip(_once(f"{pre}_double", mode, lambda: dbl(P, 3, mode=mode)),
                                                  hf.double_plain(g2, P, 3)))
    addx = hf.g2_addx if g2 else hf.g1_addx
    got, gexc = _once(f"{pre}_addx", mode, lambda: addx(P, Qd, mode=mode))
    exp, eexc = hf.addx_plain(g2, P, Qd)
    assert all(torch.equal(x, y) for x, y in zip(got, exp)) and torch.equal(gexc, eexc)
    assert gexc[: len(ADDX_EXC)].tolist() == ADDX_EXC
    pts, codes = scan_lanes(g2, 64, 1024, 16, random.Random(22 + g2))
    pxy = (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(pts, dev)
    c = torch.from_numpy(codes).to(dev)
    scan = hf.g2_madd_scan if g2 else hf.g1_madd_scan
    (acc2, exc2) = _once(f"{pre}_madd_scan", mode, lambda: scan(pxy, c, mode=mode))
    pacc, pexc = hf.madd_scan_plain(g2, pxy, c)
    assert all(torch.equal(x, y) for x, y in zip(acc2, pacc)) and torch.equal(exc2, pexc)
    assert exc2[: len(SCAN_EXC)].tolist() == SCAN_EXC
    rows, bw = 2, 512
    grid = tuple(t.reshape((rows, bw) + tuple(t.shape[1:])) for t in _put(shift_grid(g2, rows, bw, random.Random(23)),
                                                                          3, dev))
    shift_add = hf.g2_add_shift if g2 else hf.g1_add_shift
    for shift in (1, 2, 4, 256):
        assert all(torch.equal(x, y) for x, y in zip(_once(f"{pre}_add_shift", mode, lambda: shift_add(
            grid, shift, mode=mode)), hf.add_shift_plain(g2, grid, shift))), shift
    if g2:
        for lanes in (1, 16, 33):
            tp, tq = (_put(pts, 3, dev) for pts in team_add_lanes(True, lanes, random.Random(lanes)))
            assert all(torch.equal(x, y) for x, y in zip(_once("g2_add", mode, lambda: hf.g2_add(tp, tq, mode=mode)),
                                                          hf.add_plain(True, tp, tq))), lanes


@pytest.mark.parametrize("mode", CURVE_MODES)
@pytest.mark.parametrize("name,N", [("fq", Q), ("fr", R)])
def test_mont_inv_modes_match_plain(dev, name, N, mode):
    spec = lb.spec_for(name)
    rnd = random.Random(24)
    xs = [0, 1, N - 1, spec.mont_r % N] + [rnd.randrange(N) for _ in range(460)]
    a = lb.ints_to_tensor(xs, spec, dev)
    got = _once(f"mont_inv_{name}", mode, lambda: hf.mont_inv(name, a, mode))
    assert torch.equal(got, hf.mont_inv_plain(name, a))
    assert list(lb.tensor_to_ints(got, spec)) == [pow(x, N - 2, N) for x in xs]


def test_fold_launch_uploads_its_units_matrix_first(dev):
    """The fold unit's __constant__ matrix of Fq, which its dp4a instances
    read (the distinct add among them), is written before its first launch
    on a card: with zeros put there and the record of the upload dropped,
    the next fold launch uploads it again and is right; a launch of the Fq
    inversion chain (on the tensor cores) after it is right too."""
    lib = hf._lib()
    p, q, *_ = special_lanes(False, 256, random.Random(25))
    P, Qd = _put(p, 3, dev), _put(q, 3, dev)
    key = (lib.vs_curve_fold_upload.__name__, 0, P[0].device.index)
    want = hf.add_distinct_plain(False, P, Qd)
    assert all(torch.equal(x, y) for x, y in zip(hf.g1_add_distinct(P, Qd, mode="fold"), want))
    assert key in hf._fold_uploaded
    zeros = np.zeros(fold_mul.packed_matrix(lb.FQ).size, np.int32)
    with torch.cuda.device(dev):
        assert lib.vs_curve_fold_upload(0, zeros.ctypes.data, zeros.size) == 0
    # the matrix is what the fold reads: zeros in place give other limbs
    assert not all(torch.equal(x, y) for x, y in zip(hf.g1_add_distinct(P, Qd, mode="fold"), want))
    hf._fold_uploaded.discard(key)
    assert all(torch.equal(x, y) for x, y in zip(hf.g1_add_distinct(P, Qd, mode="fold"), want))
    rnd = random.Random(26)
    a = lb.ints_to_tensor([rnd.randrange(Q) for _ in range(64)], lb.FQ, dev)
    assert torch.equal(hf.mont_inv("fq", a, "fold"), hf.mont_inv_plain("fq", a))
    assert key in hf._fold_uploaded


@pytest.mark.parametrize("mode", CURVE_MODES)
def test_vote_in_mode_launches_its_instances_and_gives_the_golden(dev, mode, monkeypatch):
    """A depth-2 vote (the device arm) with VSTPU_MUL naming the mode, as a
    user selects it: every kernel it launches is that mode's instance, the
    curve kernels and the inversions among them, and the ballots are the
    golden ones."""
    from vote_saver_tpu_torch.protocol import phases

    root = pathlib.Path(__file__).resolve().parents[1]
    golden = json.loads((root / "tests" / "golden" / "torch_slice_d2.json").read_text())
    e = pickle.loads((root / golden["source"]).read_bytes())
    monkeypatch.setenv("VSTPU_MUL", mode)
    assert hf.mul_mode() == mode and os.environ["VSTPU_MUL"] == mode
    ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"],
                                      e["pk_eid"], e["pk_crs"], e["vk_crs"], device="cuda")
    hf.reset_launches()
    ballots = phases.vote_with_context(ctx, golden["voters"], golden["votes"],
                                       [e["voters"][i][1] for i in golden["voters"]], FrRandom(golden["seed"]))
    torch.cuda.synchronize()
    launched = {k: v for k, v in hf.launches.items() if v}
    assert launched and all(hf.mode_of(k) == mode for k in launched), launched
    curve = [hf.instance(k, mode) for k in ("g1_madd_scan", "g2_madd_scan", "g1_add", "g2_add", "g1_double",
                                             "g2_double", "mont_inv_fr")]
    assert all(launched.get(k) for k in curve), launched
    assert [[x.hex() for x in b] for b in ballots] == [[g[k] for k in ("proof", "pinput", "ct", "sn")]
                                                       for g in golden["ballots"]]


# the widths the tensor-core instances are held to their plain versions at:
# one lane, Horner's 16, a warp short and a warp past, the batch's widest
# orphan merge, 2^14
MMA_LANES = (1, 16, 31, 33, 5925, 1 << 14)


@pytest.mark.parametrize("lanes", MMA_LANES)
def test_fold_mma_instances_match_plain(dev, lanes):
    """The fold unit's bucket scans, suffix rounds and doublings of G1 and
    G2, its G1 complete add and its Fr inversion chain, whose fold product
    runs on the tensor cores (a warp's lanes one
    tile; the lanes past n of a ragged warp compute on lane n - 1 and store
    nothing): each one launch of its fold instance, equal to the plain
    version, the doublings with `times` 1 and 10, the suffix rounds over one
    row of `lanes` buckets (shift_grid's special lanes) at shifts 1, 2, 32
    and lanes // 2, the scans on scan_lanes' special lanes (lanes 0-6, the
    doubling corner among them) and 16 rows; the G1 complete add on the
    special lanes, the Fr inversion chain on 0, 1, r - 1, R mod r and
    random lanes."""
    p, q, *_ = special_lanes(False, max(lanes, 8), random.Random(29 + lanes))
    P, Qd = (tuple(c[:lanes].contiguous() for c in _put(pts, 3, dev)) for pts in (p, q))
    got = _once("g1_add", "fold", lambda: hf.g1_add(P, Qd, mode="fold"))
    assert all(torch.equal(x, y) for x, y in zip(got, hf.add_plain(False, P, Qd)))
    rnd = random.Random(28 + lanes)
    xs = ([0, 1, R - 1, lb.FR.mont_r % R] + [rnd.randrange(R) for _ in range(max(lanes, 4) - 4)])[:lanes]
    a = lb.ints_to_tensor(xs, lb.FR, dev)
    got = _once("mont_inv_fr", "fold", lambda: hf.mont_inv("fr", a, "fold"))
    assert torch.equal(got, hf.mont_inv_plain("fr", a))
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        p, *_ = special_lanes(g2, max(lanes, 8), random.Random(30 + lanes + g2))
        P = tuple(c[:lanes].contiguous() for c in _put(p, 3, dev))
        dbl = hf.g2_double if g2 else hf.g1_double
        for times in (1, 10):
            got = _once(f"{pre}_double", "fold", lambda: dbl(P, times, mode="fold"))
            assert all(torch.equal(x, y) for x, y in zip(got, hf.double_plain(g2, P, times))), (g2, times)
        grid = tuple(c[:lanes].reshape((1, lanes) + tuple(c.shape[1:]))
                     for c in _put(shift_grid(g2, 1, max(lanes, 16), random.Random(35 + lanes + 2 * g2)), 3, dev))
        shift_add = hf.g2_add_shift if g2 else hf.g1_add_shift
        for shift in sorted({1, 2, 32, max(lanes // 2, 1)}):
            got = _once(f"{pre}_add_shift", "fold", lambda: shift_add(grid, shift, mode="fold"))
            assert all(torch.equal(x, y) for x, y in zip(got, hf.add_shift_plain(g2, grid, shift))), (g2, shift)
        pts, codes = scan_lanes(g2, 64, max(lanes, 64), 16, random.Random(31 + lanes + 2 * g2))
        pxy = (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(pts, dev)
        c = torch.from_numpy(codes[:, :lanes].copy()).to(dev)
        scan = hf.g2_madd_scan if g2 else hf.g1_madd_scan
        acc, exc = _once(f"{pre}_madd_scan", "fold", lambda: scan(pxy, c, mode="fold"))
        pacc, pexc = hf.madd_scan_plain(g2, pxy, c)
        assert all(torch.equal(x, y) for x, y in zip(acc, pacc)) and torch.equal(exc, pexc), g2
        assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC[:lanes]


@pytest.mark.parametrize("g2,lanes", [(False, None), (True, None), (True, 16), (True, 71)],
                         ids=["g1", "g2", "g2-16", "g2-71"])
def test_fold_mma_scan_matches_plain_at_the_path_shape(dev, g2, lanes):
    """The fold scan at the vote path's h schedule (G1: 80 rows x 248,832
    lanes; G2: its first 32 rows, and their first 16 and 71 lanes, half a
    warp and a ragged third warp) over a table of 2^15 - 1 random field
    elements, equal to its plain version and to the loop instance."""
    from vote_saver_tpu_torch.testing import h_schedule

    gen = torch.Generator(device=dev).manual_seed(32 + g2)
    n = (1 << 15) - 1
    tail = (2, lb.FQ.num_limbs) if g2 else (lb.FQ.num_limbs,)
    table = tuple(micro.random_limbs("fq", n * len(tail), dev, gen).reshape((n,) + tail) for _ in range(2))
    codes = torch.from_numpy(h_schedule(32).codes).to(dev)
    assert tuple(codes.shape) == (80, 248832)
    codes = codes[:32, :lanes].contiguous() if g2 else codes
    pre, scan = ("g2", hf.g2_madd_scan) if g2 else ("g1", hf.g1_madd_scan)
    acc, exc = _once(f"{pre}_madd_scan", "fold", lambda: scan(table, codes, mode="fold"))
    for want in (hf.madd_scan_plain(g2, table, codes), scan(table, codes, mode="loop")):
        assert all(torch.equal(x, y) for x, y in zip(acc, want[0])) and torch.equal(exc, want[1])


def test_fold_mma_launch_uploads_its_b_operand_first(dev, monkeypatch):
    """The tensor-core fold's B operands are in the curve unit's device
    memory before its first launch on a card: with zeros put in Fq's and
    the record of the upload dropped, the next launch of any of the nine
    Fq instances uploads it again and gives the plain limbs; likewise Fr's
    for the Fr inversion chain, which a launch finds uploaded once per
    card, before it; the runtime reports each instance with its shared
    memory a block: 55,936 B (Fq's B operand and four warp tiles, dynamic),
    92,800 B in the G2 scan, whose block also parks its 128 accumulators
    there, 34,944 B in the Fr chain (Fr's B operand and four warp tiles),
    and in the G2 team add 55,936 B and 18,192 B of static memory (eight
    teams' 39 slots and the table)."""
    lib = hf._lib()
    p, q, *_ = special_lanes(False, 256, random.Random(33))
    P, Qd = _put(p, 3, dev), _put(q, 3, dev)
    pts, codes = scan_lanes(False, 64, 256, 8, random.Random(34))
    pxy = ms.g1_affine_to_device(pts, dev)
    c = torch.from_numpy(codes).to(dev)
    p2, *_ = special_lanes(True, 32, random.Random(36))
    P2 = _put(p2, 3, dev)
    grid = tuple(c.reshape(4, 64, -1) for c in _put(shift_grid(False, 4, 64, random.Random(37)), 3, dev))
    pts2, codes2 = scan_lanes(True, 64, 96, 8, random.Random(41))
    pxy2 = ms.g2_affine_to_device(pts2, dev)
    c2 = torch.from_numpy(codes2).to(dev)
    grid2 = tuple(c.reshape(2, 64, 2, -1) for c in _put(shift_grid(True, 2, 64, random.Random(42)), 3, dev))
    rnd = random.Random(43)
    a = lb.ints_to_tensor([0, 1, R - 1] + [rnd.randrange(R) for _ in range(45)], lb.FR, dev)
    aq = lb.ints_to_tensor([0, 1, Q - 1] + [rnd.randrange(Q) for _ in range(45)], lb.FQ, dev)
    tp, tq = (_put(pts, 3, dev) for pts in team_add_lanes(True, 48, random.Random(48)))
    want = (hf.double_plain(False, P, 2), hf.madd_scan_plain(False, pxy, c)[0], hf.add_shift_plain(False, grid, 1),
            hf.double_plain(True, P2, 2), hf.madd_scan_plain(True, pxy2, c2)[0], hf.add_shift_plain(True, grid2, 1),
            hf.add_plain(False, P, Qd), (hf.mont_inv_plain("fq", aq),), hf.add_plain(True, tp, tq))

    def right():
        got = (hf.g1_double(P, 2, mode="fold"), hf.g1_madd_scan(pxy, c, mode="fold")[0],
               hf.g1_add_shift(grid, 1, mode="fold"), hf.g2_double(P2, 2, mode="fold"),
               hf.g2_madd_scan(pxy2, c2, mode="fold")[0], hf.g2_add_shift(grid2, 1, mode="fold"),
               hf.g1_add(P, Qd, mode="fold"), (hf.mont_inv("fq", aq, "fold"),), hf.g2_add(tp, tq, mode="fold"))
        return tuple(all(torch.equal(x, y) for x, y in zip(g, w)) for g, w in zip(got, want))

    def inv_right():
        return torch.equal(hf.mont_inv("fr", a, "fold"), hf.mont_inv_plain("fr", a))

    upload = lib.vs_curve_fold_mma_upload
    key = (upload.__name__, 0, P[0].device.index)
    fr_key = (upload.__name__, 1, P[0].device.index)
    assert right() == (True,) * 9 and key in hf._fold_uploaded
    for field, spec, k in ((0, lb.FQ, key), (1, lb.FR, fr_key)):
        zeros = np.zeros(fold_mul.mma_operand(spec).size, np.int8)
        with torch.cuda.device(dev):
            assert upload(field, zeros.ctypes.data, zeros.size) == 0
        if field == 0:
            assert right() == (False,) * 9  # the B operand is what the tensor-core fold reads
            assert inv_right()  # the Fr chain reads Fr's
        else:
            assert not inv_right() and right() == (True,) * 9
        hf._fold_uploaded.discard(k)
    # Fq's operand is in place again (the Fr pass's launches re-uploaded it); the Fr chain's next launch
    # uploads Fr's, once, before it
    calls = []

    def recording(name, fn):
        def call(*args):
            calls.append((name, args[0]) if name == "upload" else (name,))
            return fn(*args)

        call.__name__ = fn.__name__
        return call

    lib_rec = type("Lib", (), {})()
    for name in dir(lib):
        if name.startswith("vs_"):
            setattr(lib_rec, name, getattr(lib, name))
    lib_rec.vs_curve_fold_mma_upload = recording("upload", upload)
    lib_rec.vs_mont_inv_fold = recording("launch", lib.vs_mont_inv_fold)
    monkeypatch.setattr(hf, "_lib", lambda: lib_rec)
    assert inv_right() and inv_right()
    assert calls == [("upload", 1), ("launch",), ("launch",)], calls
    assert right() == (True,) * 9 and {key, fr_key} <= hf._fold_uploaded
    smem = {"g2_madd_scan_fold": 92800, "mont_inv_fr_fold": 34944, "g2_add_fold": 55936 + 18192}
    for name in hf.MMA_KERNELS:
        info = hf.mma_info(name, dev)
        assert info["smem_bytes"] == smem.get(name, 55936) and info["warps_per_sm"] >= 4, info
        assert info["registers"] <= 255, info


# the widths the fold G1 complete add is held to its plain version at: one
# lane, Horner's 16, a warp's 32, one past each, a ragged 71, the ballot
# tail's 480, 2^14
G1_ADD_LANES = (1, 16, 17, 32, 33, 71, 480, 1 << 14)


@pytest.mark.parametrize("lanes", G1_ADD_LANES)
def test_fold_g1_add_matches_plain(dev, lanes):
    """The fold G1 complete add, whose block's four warps share each 32
    lanes' 16 Fq products on the tensor cores, one launch, equal to its
    plain version and to the loop instance, on testing.special_lanes (the
    doubling in block 0) with one more doubling lane alone in its block
    (the last lane of every other block from 64 lanes on: its block runs
    the doubling for that lane alone, the block-uniform test)."""
    p, q, *_ = special_lanes(False, max(lanes, 8), random.Random(44 + lanes))
    for k in range(32 + 31, lanes, 64):
        q[k] = p[k]
    P, Qd = (tuple(c[:lanes].contiguous() for c in _put(pts, 3, dev)) for pts in (p, q))
    got = _once("g1_add", "fold", lambda: hf.g1_add(P, Qd, mode="fold"))
    for want in (hf.add_plain(False, P, Qd), hf.g1_add(P, Qd, mode="loop")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("lanes", (1, 16, 17, 33, 1 << 16))
def test_fold_mont_inv_fr_matches_plain(dev, lanes):
    """The fold Fr inversion chain, its Fr fold on the tensor cores, one
    launch at the device witness's 16 lanes, ragged widths and 2^16 lanes,
    on 0, 1, r - 1, R mod r and random lanes: equal to its plain version,
    the loop instance and Python's pow."""
    rnd = random.Random(45 + lanes)
    xs = ([0, 1, R - 1, lb.FR.mont_r % R] + [rnd.randrange(R) for _ in range(max(lanes, 4) - 4)])[:lanes]
    a = lb.ints_to_tensor(xs, lb.FR, dev)
    got = _once("mont_inv_fr", "fold", lambda: hf.mont_inv("fr", a, "fold"))
    for want in (hf.mont_inv_plain("fr", a), hf.mont_inv("fr", a, "loop")):
        assert torch.equal(got, want)
    assert list(lb.tensor_to_ints(got[:64], lb.FR)) == [pow(x, R - 2, R) for x in xs[:64]]


# the widths the fold G2 complete add (the converged team add) is held to
# its plain version at: one lane, Horner's 16, one past, the ballot tail's
# 32, one past, a ragged 71, the batch's widest orphan merge, 2^14
G2_ADD_LANES = (1, 16, 17, 32, 33, 71, 5925, 1 << 14)


@pytest.mark.parametrize("lanes", G2_ADD_LANES)
def test_fold_g2_add_matches_plain(dev, lanes):
    """The fold G2 complete add, a team of 16 threads a lane and two teams
    a warp whose every multiply phase is one tile on the tensor cores, one
    launch, equal to its plain version and to the loop instance, on
    testing.team_add_lanes (warps pairing the outcomes q and p, q and the
    doubling, the doubling and opposite points, the infinities with random
    x and y) with lane 13 of every 64 a doubling beside a generic add in its
    warp, and the last lane a doubling (alone in its warp where n is odd)."""
    p, q = team_add_lanes(True, lanes, random.Random(46 + lanes))
    for k in [k for k in range(lanes) if k % 64 == 13] + [lanes - 1]:
        q[k] = p[k]
    P, Qd = _put(p, 3, dev), _put(q, 3, dev)
    got = _once("g2_add", "fold", lambda: hf.g2_add(P, Qd, mode="fold"))
    for want in (hf.add_plain(True, P, Qd), hf.g2_add(P, Qd, mode="loop")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("lanes", (1, 16, 17, 33, 464))
def test_fold_mont_inv_fq_matches_plain(dev, lanes):
    """The fold Fq inversion chain, its Fq fold on the tensor cores, one
    launch at ragged widths and the ballot tail's 464 lanes, on 0, 1,
    q - 1, R mod q and random lanes: equal to its plain version, the loop
    instance and Python's pow."""
    rnd = random.Random(47 + lanes)
    xs = ([0, 1, Q - 1, lb.FQ.mont_r % Q] + [rnd.randrange(Q) for _ in range(max(lanes, 4) - 4)])[:lanes]
    a = lb.ints_to_tensor(xs, lb.FQ, dev)
    got = _once("mont_inv_fq", "fold", lambda: hf.mont_inv("fq", a, "fold"))
    for want in (hf.mont_inv_plain("fq", a), hf.mont_inv("fq", a, "loop")):
        assert torch.equal(got, want)
    assert list(lb.tensor_to_ints(got, lb.FQ)) == [pow(x, Q - 2, Q) for x in xs]


def _suffix_grid(rows: int, bw: int, seed: int, dev, g2: bool = False):
    """A (rows, bw) grid of random field elements as G1 (G2) coordinates,
    with shift_grid's special lanes (equal operands, the same limbs,
    opposite points, both infinities) in the first 16 of row 0, as
    chip_smoke's suffix grid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tail = (2, lb.FQ.num_limbs) if g2 else (lb.FQ.num_limbs,)
    grid = [micro.random_limbs("fq", rows * bw * len(tail), dev, gen).reshape((rows, bw) + tail) for _ in range(3)]
    for k, c in enumerate(_put(shift_grid(g2, 1, 16, random.Random(seed)), 3, dev)):
        grid[k][0, :16] = c
    return tuple(grid)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("shift", (1, 2, 16, 32, 256))
def test_fold_mma_add_shift_matches_plain_at_the_path_shape(dev, shift, g2):
    """The fold suffix round, whose fold product runs on the tensor cores,
    on the combination phase's 432 x 512 grid, one launch, equal to its
    plain version and to the loop instance; from shift 32 on, shift / 32
    of each row's 16 warps have no partner and skip the add."""
    grid = _suffix_grid(432, 512, 38 + g2, dev, g2)
    pre, shift_add = ("g2", hf.g2_add_shift) if g2 else ("g1", hf.g1_add_shift)
    got = _once(f"{pre}_add_shift", "fold", lambda: shift_add(grid, shift, mode="fold"))
    for want in (hf.add_shift_plain(g2, grid, shift), shift_add(grid, shift, mode="loop")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("rows", (1, 3, 7))
def test_fold_mma_add_shift_matches_plain_on_a_ragged_grid(dev, rows, g2):
    """The fold suffix round on grids of bw = 16 (a warp spans two rows;
    with an odd row count the last warp is ragged) at every shift 1-15,
    equal to its plain version and to the loop instance."""
    pts = shift_grid(g2, rows, 16, random.Random(39 + rows + 8 * g2))
    grid = tuple(c.reshape((rows, 16) + tuple(c.shape[1:])) for c in _put(pts, 3, dev))
    pre, shift_add = ("g2", hf.g2_add_shift) if g2 else ("g1", hf.g1_add_shift)
    for shift in range(1, 16):
        got = _once(f"{pre}_add_shift", "fold", lambda: shift_add(grid, shift, mode="fold"))
        for want in (hf.add_shift_plain(g2, grid, shift), shift_add(grid, shift, mode="loop")):
            assert all(torch.equal(x, y) for x, y in zip(got, want)), shift


@pytest.mark.parametrize("lanes,times", [(16, 10), (32, 4), (2 * 32 + 7, 1), (2 * 32 + 7, 10)])
def test_fold_mma_g2_double_matches_plain(dev, lanes, times):
    """The fold G2 doubling, whose Fq2 multiply's products run on the
    tensor cores, at the vote path's widths and counts (Horner's 16 lanes x
    10, the ballot tail's 32 x 4) and a ragged 71 lanes, one launch each,
    equal to its plain version and to the loop instance."""
    p, *_ = special_lanes(True, lanes, random.Random(40 + lanes))
    P = _put(p, 3, dev)
    got = _once("g2_double", "fold", lambda: hf.g2_double(P, times, mode="fold"))
    for want in (hf.double_plain(True, P, times), hf.g2_double(P, times, mode="loop")):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
