"""Inputs that drive every special lane of the curve kernels K2-K6 and of
setup's window sum, and the host stand-ins of the CPU tests' sharded ranks.

Shared by the CPU tests and chip_smoke.py, so the kernels meet the same
corner cases on the card as their plain versions meet against the Pallas
formulas on the CPU.  Host ints only; callers move them to tensors.

``sharded_test_rank`` is what the CPU tests run on each spawned rank (a
rank imports this package, never a test module): the sharded functions on
their cases, then a vote with the scheduled MSMs and the ballot tail as
host stand-ins (``host_msm_device``, ``host_tail``), since their plain
versions take tens of minutes for one depth-2 batch on the CPU.
``scale_test_rank`` runs a sharded ``scale.run`` with the same stand-ins,
one rank held back as a slow rank would be.
"""

from __future__ import annotations

import contextlib
import pathlib
import random
import time

import numpy as np
import torch

from .params import Q, R
from .refimpl import curves as rc
from .refimpl import field as rf
from .refimpl import jacobian as rj


@contextlib.contextmanager
def torch_threads(n: int):
    """Run with n intra-op CPU threads, restoring the count after.  The
    test rig runs several pytest workers on one host, and the plain
    versions' many small ops slow down several-fold when every worker's
    torch also spawns a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# madd lanes 0-7: acc infinite lifts q (+, -), (0, 0) q, inactive, doubling
# corner, opposite by sign, opposite by acc = -q, generic
MADD_SIGN = [False, True, False, False, False, True, False, True]
MADD_ACTIVE = [True, True, True, False, True, True, True, True]
MADD_EXC = [0, 0, 0, 0, 1, 0, 0, 0]
# flagged distinct add (K5/K6) of p + q on the same lanes: p = q (lanes 3, 4)
ADDX_EXC = [0, 0, 0, 1, 1, 0, 0, 0]


# bucket-scan lanes 0-6 (scan_lanes): idle, the doubling corner, opposite
# then lifted again, only the (0, 0) point, (0, 0) between points, signs,
# idle rows between entries
SCAN_EXC = [0, 1, 0, 0, 0, 0, 0]


def window_scalars(n: int, rnd: random.Random) -> list[int]:
    """n >= 6 scalars for FixedBaseTable's window sum (32 windows of 8
    bits): 0, 1 and R - 1, a scalar whose low 16 windows are zero (an
    infinite left subtree), one whose high 16 windows are zero, one with a
    single nonzero window (below window 31, so below R), then n - 6 random
    scalars."""
    low_zero = rnd.randrange(1, R >> 128) << 128
    high_zero = rnd.randrange(1, 1 << 128)
    single = rnd.randrange(1, 256) << (8 * rnd.randrange(31))
    return [0, 1, R - 1, low_zero, high_zero, single] + [rnd.randrange(R) for _ in range(n - 6)]


def neg_y(y, g2: bool):
    return rf.fq2_neg(y) if g2 else (Q - y) % Q


def jacobian(p, z, g2: bool):
    """Affine point -> Jacobian ints (x z^2, y z^3, z)."""
    if g2:
        z2 = rf.fq2_sq(z)
        return (rf.fq2_mul(p[0], z2), rf.fq2_mul(p[1], rf.fq2_mul(z2, z)), z)
    return (p[0] * z * z % Q, p[1] * z * z % Q * z % Q, z)


def special_lanes(g2: bool, n: int, rnd: random.Random):
    """(p, q, acc, q_affine, sign, active) for n >= 8 lanes.

    Complete add p + q, lanes 0-5: inf + q, p + inf, inf + inf, p + p with
    the same limbs, p + p with another Z, p + (-p).  Mixed add acc += q
    (affine, signed, maybe inactive): lanes 0-7 as MADD_SIGN / MADD_ACTIVE,
    with the exc flag expected as MADD_EXC.  The other lanes are random
    points with random Z (and random sign / 90% active for the madd)."""
    gen, group = (rc.g2_gen, "g2") if g2 else (rc.g1_gen, "g1")
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    inf = (one, one, zero)

    def rz():
        return (rnd.randrange(1, Q), rnd.randrange(Q)) if g2 else rnd.randrange(1, Q)

    aff = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, 1 << 255) for _ in range(2 * n)])
    pa, qa = aff[:n], aff[n:]
    p = [jacobian(a, rz(), g2) for a in pa]
    q = [jacobian(a, rz(), g2) for a in qa]
    p[0], q[1], p[2], q[2] = inf, inf, inf, inf
    q[3] = p[3]
    q[4] = jacobian(pa[4], rz(), g2)
    q[5] = jacobian((pa[5][0], neg_y(pa[5][1], g2)), rz(), g2)
    acc, qm = list(p), list(qa)
    sign = MADD_SIGN + [rnd.random() < 0.5 for _ in range(n - 8)]
    active = MADD_ACTIVE + [rnd.random() < 0.9 for _ in range(n - 8)]
    acc[1] = inf
    qm[2] = (zero, zero)
    acc[4] = jacobian(qm[4], rz(), g2)
    acc[5] = jacobian(qm[5], rz(), g2)
    acc[6] = jacobian((qm[6][0], neg_y(qm[6][1], g2)), rz(), g2)
    return p, q, acc, qm, sign, active


def scan_lanes(g2: bool, npts: int, lanes: int, steps: int, rnd: random.Random):
    """(affine points, (steps, lanes) int32 codes) for the bucket scan.

    Point 1 is None ((0, 0) on the device).  Lanes 0-6 as SCAN_EXC says,
    over the first four rows; lane 1 adds point 2 twice, so its second madd
    is the doubling corner.  Every other entry is a random sign and a point
    that appears at most once in its lane (no further corner), with about
    one idle row in five.  Needs npts >= max(16, steps + 2) and steps >= 4."""
    gen, group = (rc.g2_gen, "g2") if g2 else (rc.g1_gen, "g1")
    pts = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, 1 << 255) for _ in range(npts)])
    pts[1] = None

    def enc(p, neg=False):
        return (p + 1) | (int(neg) << 30)

    codes = np.zeros((steps, lanes), np.int64)
    for lane in range(7, lanes):
        for s, p in enumerate(rnd.sample(range(2, npts), steps)):
            if rnd.random() < 0.8:
                codes[s, lane] = enc(p, rnd.random() < 0.5)
    special = {
        1: [enc(2), enc(2), enc(14, True), enc(15)],
        2: [enc(3), enc(3, True), enc(4), enc(5, True)],
        3: [enc(1), enc(1, True), 0, enc(1)],
        4: [enc(6), enc(1), enc(7, True), enc(8)],
        5: [enc(9, True), enc(10, True), enc(11), 0],
        6: [0, enc(12), 0, enc(13)],
    }
    for lane, col in special.items():
        codes[:4, lane] = col
        codes[4:, lane] = 0
    codes[:, 0] = 0
    return pts, codes.astype(np.int32)


def shift_grid(g2: bool, rows: int, bw: int, rnd: random.Random):
    """rows * bw Jacobian int points (random Z) for the suffix round, row 0
    holding the special lanes (bw >= 16): 0 and 1 the same point with other
    Z (equal operands at shift 1), 2 and 4 the same limbs (shift 2), 3 and
    7 opposite (shift 4), 5 canonical infinity, 6 infinity with random x
    and y, and lane bw - 1 infinity (no partner at any shift)."""
    gen, group = (rc.g2_gen, "g2") if g2 else (rc.g1_gen, "g1")
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)

    def rz():
        return (rnd.randrange(1, Q), rnd.randrange(Q)) if g2 else rnd.randrange(1, Q)

    aff = rj.FixedBaseHost(gen, group).mul_many([rnd.randrange(1, 1 << 255) for _ in range(rows * bw)])
    pts = [jacobian(a, rz(), g2) for a in aff]
    pts[1] = jacobian(aff[0], rz(), g2)
    pts[4] = pts[2]
    pts[7] = jacobian((aff[3][0], neg_y(aff[3][1], g2)), rz(), g2)
    pts[5] = (one, one, zero)
    pts[6] = (rz(), rz(), zero)
    pts[bw - 1] = (one, one, zero)
    return pts


def h_schedule(seed: int, parts: int = 16, n: int = (1 << 15) - 1, w: int = 10):
    """A schedule of the depth-6 B = 16 vote path's h MSM: `parts` vectors
    of n uniform scalars below 2^254 over one point set, w = 10, which
    _fit_shape sizes to 80 rows of 248,832 lanes (16 x 27 x 512 bucket
    lanes and 27,648 orphan lanes)."""
    from .ops import msm_sched as ms

    limbs = np.random.default_rng(seed).integers(0, 1 << 32, (parts, n, 8), dtype=np.uint32)
    limbs[..., 7] &= 0x3FFFFFFF
    return ms.build_schedule_multi(list(limbs), w)


# complete-add lanes of team_add_lanes past special_lanes' 0-5: (0, 0, 0) as
# p, as q and as both, then infinity with random x and y as p and as q
TEAM_EXTRA = 5


def team_add_lanes(g2: bool, n: int, rnd: random.Random, period: int = 64):
    """(p, q) Jacobian int points for n lanes of the complete add, the
    pattern of `period` >= 16 lanes repeated: lanes 0-5 as special_lanes
    (inf + q, p + inf, inf + inf, p + p with the same limbs, p + p with
    another Z, p + (-p): h = 0 with r != 0), lanes 6-10 the TEAM_EXTRA
    infinities, the rest random points with random Z."""
    p, q, *_ = special_lanes(g2, period, rnd)
    zero = (0, 0) if g2 else 0

    def rz():
        return (rnd.randrange(1, Q), rnd.randrange(Q)) if g2 else rnd.randrange(1, Q)

    p[6] = (zero, zero, zero)
    q[7] = (zero, zero, zero)
    p[8] = q[8] = (zero, zero, zero)
    p[9] = (rz(), rz(), zero)
    q[10] = (rz(), rz(), zero)
    return [p[i % period] for i in range(n)], [q[i % period] for i in range(n)]


# ---------------------------------------------------------------------------
# Host stand-ins for the CPU tests' sharded ranks
# ---------------------------------------------------------------------------


def schedule_scalars(sched) -> list[list[int]]:
    """The scalars a msm_sched.Schedule encodes, per part and point, decoded
    from its codes and orphan plan: an orphan lane counts for the bucket
    whose run holds it (``merge_gather``), a bucket lane is (part, window,
    |digit|), and a code (point + 1) | sign << 30."""
    codes = np.asarray(sched.codes)
    canon = sched.merge_gather.shape[0]
    bw = 1 << (sched.window_bits - 1)
    K, parts = sched.num_windows, sched.num_parts
    step, lane = np.nonzero(codes)
    code = codes[step, lane].astype(np.int64)
    heads = np.nonzero(sched.merge_gather)[0]
    bases = sched.merge_gather[heads].astype(np.int64) - 1
    orphan = lane >= canon
    bucket = lane.astype(np.int64)
    bucket[orphan] = heads[np.searchsorted(bases, lane[orphan] - canon, side="right") - 1]
    point = (code & ((1 << 30) - 1)) - 1
    digit = (bucket % bw + 1) * np.where(code >> 30, -1, 1)
    n = int(point.max()) + 1 if point.size else 0
    digits = np.zeros((parts, n, K), dtype=np.int64)
    np.add.at(digits, (bucket // (bw * K), point, bucket // bw % K), digit)
    weights = np.array([1 << (sched.window_bits * j) for j in range(K)], dtype=object)
    return [[int(v) % R for v in (d.astype(object) * weights).sum(axis=1)] for d in digits]


def host_msm_device(group: str, points_xy, sched):
    """msm_sched.msm_device's stand-in: each part's MSM of the scalars the
    schedule encodes (``schedule_scalars``) over the (x, y) points, by the
    native host MSM, as Jacobian coords on the points' device; no flag."""
    from . import native_bridge as nb
    from .ops import curve_ops as co
    from .ops import limbs as lb

    g2 = group == "g2"
    xs, ys = (lb.tensor_to_ints(c, lb.FQ) for c in points_xy)
    if g2:
        pts = [((int(x[0]), int(x[1])), (int(y[0]), int(y[1]))) for x, y in zip(xs, ys)]
        pts = [None if p == ((0, 0), (0, 0)) else p for p in pts]
    else:
        pts = [None if (int(x), int(y)) == (0, 0) else (int(x), int(y)) for x, y in zip(xs, ys)]
    sums = []
    for scalars in schedule_scalars(sched):
        scalars = scalars + [0] * (len(pts) - len(scalars))
        sums.append(nb.msm(pts, scalars, group=group))
    dev = points_xy[0].device
    return (co.g2_to_device if g2 else co.g1_to_device)(sums, dev), torch.zeros((), dtype=torch.bool, device=dev)


def host_tail(pk, spk, gvk, outs, votes, rng):
    """ballot_dev.finalize_ballots_device's stand-in: its host oracle, from
    the same draws of `rng`."""
    from .protocol import ballot_dev

    return ballot_dev._finalize_host(pk, spk, gvk, outs, votes, ballot_dev.draw_scalars(len(votes), rng))


def sharded_test_rank(mesh, cases: dict, vote_args: tuple) -> dict:
    """A CPU test's rank: ``entry.run_cases`` on `cases`, then, on the ranks
    at voters coordinate 0 (one `points` group), ``entry.vote(mesh,
    *vote_args)`` (a parsed context, voters, votes, secret keys, seed)
    with the host stand-ins for the scheduled MSMs and the ballot tail."""
    from . import entry
    from .ops import msm_sched as ms
    from .protocol import ballot_dev

    out = {"cases": entry.run_cases(mesh, cases)}
    if mesh.get_local_rank("voters") == 0:
        ms.msm_device = host_msm_device
        ballot_dev.finalize_ballots_device = host_tail
        out["ballots"] = entry.vote(mesh, *vote_args)
    return out


def scale_test_rank(mesh, kw: dict, cache: str, lag_s: float) -> dict:
    """A CPU test's rank of ``scale.run(**kw, mesh=mesh)`` with its caches
    under `cache` and the host stand-ins of ``sharded_test_rank``.  Every
    rank but rank 0 starts late: once rank 0 has written its first cache
    marker, or after `lag_s` seconds.  Returns the record and the ballots
    of every batch."""
    import torch.distributed as dist

    from . import scale
    from .ops import msm_sched as ms
    from .protocol import ballot_dev, phases

    ms.msm_device = host_msm_device
    ballot_dev.finalize_ballots_device = host_tail
    scale.CACHE = pathlib.Path(cache)
    ballots = []
    vote = phases.vote_with_context

    def spy(*a, **k):
        got = vote(*a, **k)
        ballots.extend(got)
        return got

    phases.vote_with_context = spy
    if dist.get_rank():
        cfg = scale.CONFIGS[kw["config"]]
        marker = scale.CACHE / f"scale_d{cfg['depth']}_v{kw.get('voters') or cfg['voters']}" / "voter_init.ok"
        deadline = time.monotonic() + lag_s
        while not marker.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
    return dict(rec=scale.run(**kw, mesh=mesh), ballots=ballots)
