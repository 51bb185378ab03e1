"""K2's bucket scan and K3's suffix-round form, on the CPU.

  * ``madd_scan_plain`` (the CPU branch of ``g1_madd_scan``/``g2_madd_scan``)
    against the JAX package's scan body (``msm_sched._msm_device``: decode
    the row, take the points, ``_jac_madd``) applied row by row with the
    Pallas formula, run eagerly on the CPU in the 16-bit layout through the
    ``env16`` fixture: limbs and ``exc`` equal, on idle lanes, (0, 0)
    points, sign bits and a doubling corner (``testing.scan_lanes``);
  * ``bucket_phase`` (one scan call) against the per-row loop of single
    madds it replaced, on scheduled MSMs with orphan lanes, in G1 and G2;
  * ``add_shift_plain`` against the roll / select / ``add_plain`` round it
    replaced, for shifts below, at and above bw, on infinity lanes (canonical
    and not), equal and opposite operands (``testing.shift_grid``);
  * ``_suffix_and_total`` given the shift form runs its rounds through it,
    reads its buckets without writing them, and gives the limbs of the
    complete adder's rolled rounds; ``msm_device`` passes it;
  * the CPU wrappers are the plain versions and count no launch;
  * ptxas's names of the new instances map to the kernels line's names
    (``_build.resource_lines``, ``chip_smoke.instance_name``).

Every comparison is exact (integer arithmetic: tolerance zero).
"""

import pathlib
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _emitter, _from_jax, _jax_cols, _port, env16  # noqa: F401
from vote_saver_tpu_torch import native_bridge as nb
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.params import R
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.testing import SCAN_EXC, scan_lanes, shift_grid, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _to_dev(g2, pts):
    return (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(pts, "cpu")


def _row_loop(group: str, points_xy, codes):
    """The bucket scan as bucket_phase ran it before the scan kernel: one
    single-row madd per schedule row, in place, exc ORed over the rows."""
    g2 = group == "g2"
    madd = hf.g2_madd if g2 else hf.g1_madd
    px, py = points_xy
    acc = (co.g2_ops() if g2 else co.g1_ops()).infinity_like(
        torch.zeros((codes.shape[1],) + tuple(px.shape[1:]), dtype=torch.int32))
    exc = torch.zeros((codes.shape[1],), dtype=torch.int32)
    for row in torch.from_numpy(codes):
        active = row != 0
        sign = ((row >> 30) & 1) != 0
        pidx = ((row & ((1 << 30) - 1)) - 1).clamp(min=0)
        acc, e = madd(acc, (px.index_select(0, pidx), py.index_select(0, pidx)), sign, active, out=acc)
        exc |= e
    return acc, exc


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bucket_scan_matches_the_row_loop(g2):
    pts, codes = scan_lanes(g2, 24, 12, 6, random.Random(100 + g2))
    pxy = _to_dev(g2, pts)
    before = dict(hf.launches)
    acc, exc = (hf.g2_madd_scan if g2 else hf.g1_madd_scan)(pxy, torch.from_numpy(codes))
    assert hf.launches == before  # CPU tensors: the plain version, no launch
    pacc, pexc = hf.madd_scan_plain(g2, pxy, torch.from_numpy(codes))
    assert all(torch.equal(a, b) for a, b in zip(acc, pacc)) and torch.equal(exc, pexc)
    lacc, lexc = _row_loop("g2" if g2 else "g1", pxy, codes)
    assert all(torch.equal(a, b) for a, b in zip(acc, lacc)) and torch.equal(exc, lexc)
    assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC and not exc[len(SCAN_EXC):].any()
    # the lanes without a corner hold the signed sums of their points
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    add, neg = (rc.g2_add, rc.g2_neg) if g2 else (rc.g1_add, rc.g1_neg)
    got = from_dev(acc)
    for lane in [0, 2, 3, 4, 5, 6] + list(range(7, codes.shape[1])):
        want = None
        for code in codes[:, lane]:
            p = pts[(int(code) & ((1 << 30) - 1)) - 1] if code else None
            if p is not None:
                want = add(want, neg(p) if (int(code) >> 30) & 1 else p)
        assert got[lane] == want, lane
    assert got[0] is None and got[3] is None


def test_bucket_scan_plain_rejects_a_code_past_the_table():
    pts, codes = scan_lanes(False, 20, 8, 4, random.Random(102))
    codes[2, 7] = 21  # point index 20 of a 20-point table
    with pytest.raises(IndexError):
        hf.madd_scan_plain(False, _to_dev(False, pts), torch.from_numpy(codes))
    with pytest.raises(IndexError):  # the wrapper, as on the card (test_torch_cuda)
        hf.g1_madd_scan(_to_dev(False, pts), torch.from_numpy(codes))
    codes[2, 7] = 20 | (1 << 30)  # the table's last point, negated: in range
    hf.madd_scan_plain(False, _to_dev(False, pts), torch.from_numpy(codes))


@pytest.mark.parametrize(
    "g2,w,parts,kind",
    [(False, 4, 1, "uniform"), (False, 5, 3, "skewed"), (True, 4, 2, "skewed")],
    ids=["g1-w4-1part", "g1-w5-3parts-orphans", "g2-w4-2parts-orphans"],
)
def test_bucket_phase_matches_the_row_loop(g2, w, parts, kind):
    """bucket_phase (one scan call, then the orphan merge) against the row
    loop followed by the same merge, on a schedule of a few hundred points;
    the skewed scalars (mostly 0 and 1) spill into orphan lanes."""
    rnd = random.Random(110 + w + parts)
    group, gen = ("g2", rc.g2_gen) if g2 else ("g1", rc.g1_gen)
    n = 64 if g2 else 200
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, R) for _ in range(n)])
    pts[5] = None
    if kind == "uniform":
        scalars = [[rnd.randrange(R) for _ in range(n)] for _ in range(parts)]
    else:
        scalars = [[rnd.choice((0, 1, 1, 1)) if i % 9 else rnd.randrange(R) for i in range(n)]
                   for _ in range(parts)]
    inf_mask = np.array([p is None for p in pts])
    sched = ms.build_schedule_multi([lb.ints_to_limbs(s, lb.FR) for s in scalars], w, inf_mask)
    if kind == "skewed":
        assert sched.merge_gather.any(), "skewed scalars must spill into orphan lanes"
    pxy = _to_dev(g2, pts)
    got, exc = ms.bucket_phase(group, pxy, sched)
    lacc, lexc = _row_loop(group, pxy, sched.codes)
    assert not bool(exc) and not lexc.any()
    canon = sched.merge_gather.shape[0]
    # the orphan merge on the loop's accumulator, as bucket_phase runs it
    can = tuple(c[:canon] for c in lacc)
    ops = ms._ops(group)
    if sched.merge_gather.any():
        orph = tuple(c[canon:] for c in lacc)
        for part_row in sched.merge_part:
            orph = ms._live_add(ops, orph, part_row)
        live = np.nonzero(sched.merge_gather)[0]
        src = torch.from_numpy(sched.merge_gather[live].astype(np.int64) - 1)
        dst = torch.from_numpy(live)
        added = ops.add(tuple(c.index_select(0, dst) for c in can), tuple(c.index_select(0, src) for c in orph))
        can = tuple(c.index_copy(0, dst, a) for c, a in zip(can, added))
    assert all(torch.equal(a, b) for a, b in zip(got, can))
    res, _ = ms.combination_phase(group, got, sched, ms._addx(group), ms._add_shift(group))
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    assert from_dev(res) == [nb.msm(pts, s, group=group) for s in scalars]


@pytest.mark.parametrize("shift", [1, 2, 4, 16, 19])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_add_shift_plain_is_the_rolled_round(g2, shift):
    """bw = 16: shift 16 and 19 leave every lane without a partner."""
    rows, bw = 2, 16
    pts = shift_grid(g2, rows, bw, random.Random(120 + g2))
    flat = _port(pts, 3)
    coords = tuple(c.reshape((rows, bw) + tuple(c.shape[1:])) for c in flat)
    ops = co.g2_ops() if g2 else co.g1_ops()
    valid = (torch.arange(bw) + shift < bw).reshape((1, bw) + (1,) * (coords[0].dim() - 2))
    rolled = tuple(torch.where(valid, torch.roll(c, -shift, dims=1), i)
                   for c, i in zip(coords, ops.infinity_like(coords[0])))
    want = hf.add_plain(g2, coords, rolled)
    got = hf.add_shift_plain(g2, coords, shift)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out = tuple(torch.empty_like(c) for c in coords)
    wrap = (hf.g2_add_shift if g2 else hf.g1_add_shift)(coords, shift, out=out)
    assert all(w is o for w, o in zip(wrap, out)) and all(torch.equal(a, b) for a, b in zip(out, want))
    # lane bw - 1 never has a partner; infinite lanes without one become
    # canonical infinity, finite ones stay as they were
    one = lb.ints_to_tensor([(1, 0)] if g2 else [1], lb.FQ)[0]
    for b in range(max(0, bw - shift), bw):
        if b in (5, 6, bw - 1):
            assert torch.equal(got[0][0, b], one) and torch.equal(got[1][0, b], one) and not got[2][0, b].any()
        else:
            assert all(torch.equal(g[0, b], c[0, b]) for g, c in zip(got, coords))
    group = "g2" if g2 else "g1"
    if shift < bw:  # the sums themselves, equal (shift 1, 2) and opposite (shift 4) operands included
        aff = [None if p[2] in (0, (0, 0)) else rj.jac_to_affine(p, group) for p in pts]
        add = rc.g2_add if g2 else rc.g1_add
        from_dev = co.g2_from_device if g2 else co.g1_from_device
        res = from_dev(tuple(c.reshape((rows * bw,) + tuple(c.shape[2:])) for c in got))
        for i in range(rows * bw):
            b = i % bw
            assert res[i] == (add(aff[i], aff[i + shift]) if b + shift < bw else aff[i]), i


def test_add_shift_rejects_a_bad_shift():
    coords = tuple(c.reshape(1, 16, -1) for c in _port(shift_grid(False, 1, 16, random.Random(130)), 3))
    for bad in (0, -2, 1.5):
        with pytest.raises(ValueError):
            hf.g1_add_shift(coords, bad)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_suffix_rounds_run_through_add_shift(g2):
    K, bw = 2, 16
    pts = shift_grid(g2, K, bw, random.Random(140 + g2))
    acc = _port(pts, 3)
    kept = tuple(c.clone() for c in acc)
    group = "g2" if g2 else "g1"
    addx, add_shift = ms._addx(group), ms._add_shift(group)
    assert add_shift is (hf.g2_add_shift if g2 else hf.g1_add_shift)
    shifts, pairs = [], []

    def counting(coords, shift, out=None):
        shifts.append(shift)
        return add_shift(coords, shift, out=out)

    def complete(p, q):
        pairs.append(1)
        return addx(p, q)

    ops = ms._ops(group)
    got, exc = ms._suffix_and_total(ops, complete, acc, K, bw, counting)
    assert shifts == [1, 2, 4, 8] * 2 and not pairs and exc is None
    assert all(torch.equal(a, b) for a, b in zip(acc, kept))  # the buckets are not written
    # without the shift form each round rolls and selects its partners for the adder: the same limbs
    rolled, rexc = ms._suffix_and_total(ops, complete, acc, K, bw)
    assert len(pairs) == 8 and rexc is None and all(torch.equal(a, b) for a, b in zip(got, rolled))


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__71d456d0_10_kernels_cu_kFqN11k_add_shiftI3Fq27MulLoopEEvPKjS4_S4_PjS5_S5_xii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__71d456d0_10_kernels_cu_kFqN11k_add_shiftI3Fq27MulLoopEEvPKjS4_S4_PjS5_S5_xii
    776 bytes stack frame, 1520 bytes spill stores, 2624 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 776 bytes cumulative stack size
ptxas info    : Function properties for _Z8mul_callI8FqParamsE2FpIT_ES3_S3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__71d456d0_10_kernels_cu_kFqN11k_madd_scanI2FpI8FqParamsE7MulCallEEvPKjS6_PKiixPjS9_S9_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__71d456d0_10_kernels_cu_kFqN11k_madd_scanI2FpI8FqParamsE7MulCallEEvPKjS6_PKiixPjS9_S9_Pi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 0 barriers
"""


def test_ptxas_report_names_each_instance():
    """chip_smoke.py's kernels line takes each instance's registers and
    spill bytes from ptxas's report through these names."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    from vote_saver_tpu_torch.ops import _build

    lines = _build.resource_lines(_PTXAS)
    assert lines == [("k_add_shift<Fq2,MulLoop>", 255, 1520), ("k_madd_scan<FqParams,MulCall>", 198, 0)]
    assert [chip_smoke.instance_name(n) for n, _r, _s in lines] == ["g2_add_shift", "g1_madd_scan"]
    assert chip_smoke.kernel_key("(anonymous namespace)::k_madd_scan<Fp<FqParams>, MulCall>(...)") \
        == "g1_madd_scan"
    assert chip_smoke.kernel_key("(anonymous namespace)::k_mont_mul<FqParams, MulV1>(...)") == "mont_mul_fq_v1"
    assert chip_smoke.instance_name("k_mont_mul_mode<FrParams,MulFold>") == "mont_mul_fr_fold"
    assert chip_smoke.instance_name("k_op<6,8>") == "op_u32_mul_wide_x8"
    assert chip_smoke.instance_name("k_mul_chain<FqParams,MulFold,1,16>") == "mul_chain_k10_fold"
    # the tensor-core fold's instances (csrc/micro.cu's k_mul_chain_mma)
    assert _build.short_name("_Z15k_mul_chain_mmaI8FqParamsLi4ELi6EEvPKjS2_PjS3_x") == "k_mul_chain_mma<FqParams,4,6>"
    assert chip_smoke.instance_name("k_mul_chain_mma<FqParams,4,6>") == "mul_chain_k7_fold"
    assert chip_smoke.instance_name("k_mul_chain_mma<FqParams,1,16>") == "mul_chain_k10_fold"
    assert chip_smoke.instance_name("mul_call<FqParams>") is None


# the emitter tests swap the JAX modules for 16-bit copies: they run last
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bucket_scan_matches_the_pallas_scan_body(env16, g2):  # noqa: F811
    """The JAX package's row scan with the Pallas madd formula, row by row:
    decode, take the row's points, _jac_madd, carry acc and exc."""
    steps, lanes = 5, 10
    pts, codes = scan_lanes(g2, 20, lanes, steps, random.Random(150 + g2))
    acc, exc = hf.madd_scan_plain(g2, _to_dev(g2, pts), torch.from_numpy(codes))
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    table = [(zero, zero) if p is None else p for p in pts]
    jacc = _jax_cols([(one, one, zero)] * lanes, 3, g2, env16)
    jexc = np.zeros(lanes, bool)
    for row in codes:
        active = row != 0
        sign = ((row >> 30) & 1).astype(bool)
        pidx = np.maximum((row & ((1 << 30) - 1)) - 1, 0)
        q = _jax_cols([table[k] for k in pidx], 2, g2, env16)
        jacc, e = env16["pf"]._jac_madd(_emitter(env16, g2), jacc, q, jnp.asarray(sign), jnp.asarray(active))
        jexc |= np.asarray(e).astype(bool)
    for got, exp in zip(acc, jacc):
        assert torch.equal(got, _from_jax(exp, g2))
    assert exc.tolist() == jexc.astype(int).tolist()
    assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC
