"""The fold mode's G1 and G2 bucket scans, suffix rounds and doublings and
its G1 complete add with their fold product on the int8 tensor cores
(``csrc/curve_fold.cu``: ``Called<MulFoldMma>`` in G1, ``MulFoldMma`` in
G2), on the CPU, against the JAX package.

On the card each Fq multiply of these instances runs the tensor-core
fold of ``csrc/fold_mma.cuh``: a warp's 32 lanes of byte pieces as one A
tile against the fold matrix, the lanes past n of a ragged warp padding
rows.  Its data flow in plain PyTorch is ``fold_mul.mul_fold_tile``.  Here
the plain formulas ``hopper_field.jac_madd`` (every multiply on every lane,
then the selects: the converged kernel's ``jac_madd_select``),
``madd_scan_plain`` and ``double_plain`` run over an Fq whose multiply is
that tile model (G2: an Fq2 over it, each Karatsuba product one tile
multiply over the lanes, as each ``fq_mul_call`` is, and the 4-warp
schedule of a G2 doubling of at most 32 lanes), at 16 lanes (half a
tile) and at 2 x 32 + 7 (the last tile ragged), on
``testing.special_lanes`` and ``testing.scan_lanes`` (idle codes, (0, 0)
points, acc at infinity, h = 0 with r != 0, the doubling corner's flag);
the suffix round as its converged kernel runs it (``_add_shift_converged``:
partners in, canonical infinity past the row's end, partner-less warps
skipped, the select-form add with the doubling on the warps that need it)
on ``testing.shift_grid`` (equal operands, the same limbs, opposite
points, both infinities) at bw = 16 over a ragged 48 lanes, every shift
1-8, and at bw = 64, shift 32 (a warp without partners); the complete
add in both forms its converged kernel had, jac_add_select (every multiply
on every lane, then the selects) and the narrow form it runs
(``_add_g1_warps``: a block's four warps sharing one 32-lane add's 16
products in 5 rounds, the doubling's 7 in 3 only on a block with a
doubling lane) on ``testing.special_lanes`` and one more doubling lane
alone in its block, the JAX formula run op by op once at 71 lanes.  They
must equal the existing plain versions and, limb for limb, the JAX package's
``_jac_madd`` / ``_jac_add(complete=True)`` / ``_jac_double`` through the
fold emitter (``FqEmitFold``, the body of ``_g1_madd_call`` /
``_g1_add_call`` / ``_g1_dbl_call`` / ``_g2_dbl_call`` under
``VSTPU_MUL=fold``), run as ``tests/test_torch_curve_modes.py`` runs them
(the JAX package unchanged), the scan row by row as
``msm_sched._msm_device`` runs it.  Also: chip_smoke.py's names and SASS
counts of the tensor-core instances, whose G1 multiply is a called device
function, and of a dp4a fold instance beside them.
Exact equality throughout.

    python -m pytest tests/test_torch_fold_curve.py -q -p no:cacheprovider
"""

import contextlib
import pathlib
import random
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _from_jax, _jax_cols, _port, env16  # noqa: F401
from test_torch_curve_modes import _emitter
from vote_saver_tpu_torch.ops import _build, fold_mul
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.testing import MADD_EXC, SCAN_EXC, scan_lanes, shift_grid, special_lanes, torch_threads

# half a warp's tile (Horner's 16 lanes), and two tiles and a ragged one
LANES = (16, 2 * fold_mul.TILE_LANES + 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _root_on_path():
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)


class TileFq(hf.HalfField):
    """Fq whose multiply is the tensor-core fold's data flow: the lanes of
    the flattened batch in tiles of 32, each tile's pieces times the B
    operand (``fold_mul.mul_fold_tile``); every other operation HalfField's."""

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        L = lb.FQ.num_limbs
        out = fold_mul.mul_fold_tile(lb.FQ, hf._pack(a).reshape(-1, L), hf._pack(b).reshape(-1, L))
        return hf._half(out).reshape(a.shape)


class TileFq2(hf.HalfField2):
    """Fq2 over TileFq as the G2 kernels multiply (``mul_modes.cuh``'s
    ``fmul`` / ``fsq`` on Fq2): each Karatsuba product (three a multiply,
    two a square) one call of the Fq multiply over all the lanes, as each
    ``fq_mul_call`` is one ``mul_fold_mma`` over a warp's lanes."""

    def mul(self, a, b):
        f = self.fq
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        t0, t1 = f.mul(a0, b0), f.mul(a1, b1)
        t2 = f.mul(f.add(a0, a1), f.add(b0, b1))
        return torch.stack([f.sub(t0, t1), f.sub(t2, f.add(t0, t1))], dim=-2)

    def sq(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t0, t1 = f.mul(f.add(a0, a1), f.sub(a0, a1)), f.mul(a0, a1)
        return torch.stack([t0, f.add(t1, t1)], dim=-2)


@contextlib.contextmanager
def _tile_fq():
    """hopper_field's plain G1 and G2 formulas over TileFq while inside:
    HALF_FQ2 was built over HALF["fq"] at import, so it is replaced too."""
    with pytest.MonkeyPatch.context() as mp:
        tile = TileFq(lb.FQ)
        mp.setitem(hf.HALF, "fq", tile)
        mp.setattr(hf, "HALF_FQ2", TileFq2(tile))
        yield


def _jax_double(env, P_host, times: int, g2: bool = False):
    """``_jac_double`` through the fold emitter, `times` times."""
    f = _emitter(env, "fold", g2)
    cols = _jax_cols(P_host, 3, g2, env)
    for _ in range(times):
        cols = env["pf"]._jac_double(f, cols)
    return tuple(_from_jax(c, g2) for c in cols)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("lanes", LANES)
def test_madd_on_the_tile_matches_the_fold_pallas_madd(env16, lanes):
    """The converged madd (all 11 multiplies on every lane, then the lift,
    the opposite-point infinity and the inactive keep, in that order) with
    the tile's multiply: the plain madd's limbs and flags, and the JAX fold
    formula's."""
    p, q, acc, qm, sign, active = special_lanes(False, lanes, random.Random(60 + lanes))
    A, QA, S, ACT = _port(acc, 3), _port(qm, 2), torch.tensor(sign), torch.tensor(active)
    want, wexc = hf.madd_plain(False, A, QA, S, ACT)
    with _tile_fq():
        out, exc = hf.jac_madd(hf._field(False), tuple(map(hf._half, A)), tuple(map(hf._half, QA)), S, ACT)
    got, exc = tuple(map(hf._pack, out)), exc.to(torch.int32)
    assert _equal(got, want) and torch.equal(exc, wexc)
    assert exc[: len(MADD_EXC)].tolist() == MADD_EXC
    f = _emitter(env16, "fold", False)
    jout, jexc = env16["pf"]._jac_madd(f, _jax_cols(acc, 3, False, env16), _jax_cols(qm, 2, False, env16),
                                       jnp.asarray(sign), jnp.asarray(active))
    assert _equal(got, tuple(_from_jax(c, False) for c in jout))
    assert exc.tolist() == [int(bool(x)) for x in np.asarray(jexc)]


@pytest.mark.parametrize("lanes", LANES)
def test_double_on_the_tile_matches_the_fold_pallas_double(env16, lanes):
    """Two doublings with the tile's multiply, canonical infinity (lane 0)
    and p = q's operands included: the plain doubling's limbs and the JAX
    fold formula's."""
    p, *_ = special_lanes(False, lanes, random.Random(70 + lanes))
    P = _port(p, 3)
    want = hf.double_plain(False, P, 2)
    with _tile_fq():
        got = hf.double_plain(False, P, 2)
    assert _equal(got, want)
    assert not got[2][0].any()
    assert _equal(got, _jax_double(env16, p, 2))


# (g2, lanes) of the scan: G1 at both widths (ids as before G2 joined), G2
# at both widths; G2 scans 4 rows, the fewest scan_lanes' special lanes need
SCAN_CASES = [pytest.param(False, n, id=str(n)) for n in LANES] + [
    pytest.param(True, n, id=f"g2-{n}") for n in LANES]


@pytest.mark.parametrize("g2,lanes", SCAN_CASES)
def test_scan_on_the_tile_matches_the_fold_pallas_row_scan(env16, g2, lanes):
    """The bucket scan with the tile's multiply (G2: an Fq2 over it, TileFq2),
    as madd_scan_plain runs it (the live lanes of each row) and as the
    converged kernel runs it (every lane of every row through the
    select-form madd): the plain scan's limbs and flags, and the JAX row
    scan with the fold formula's, on idle codes, (0, 0) points, signs and
    the doubling corner."""
    steps = 4 if g2 else 6
    pts, codes = scan_lanes(g2, 24, lanes, steps, random.Random(80 + lanes + 7 * g2))
    pxy = (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(pts, "cpu")
    c = torch.from_numpy(codes)
    want, wexc = hf.madd_scan_plain(g2, pxy, c)
    with _tile_fq():
        got, exc = hf.madd_scan_plain(g2, pxy, c)
        f = hf._field(g2)
        assert isinstance(f, TileFq2 if g2 else TileFq)
        acc = tuple(map(hf._half, hf._infinity(g2, (lanes,), "cpu")))
        kexc = torch.zeros(lanes, dtype=torch.bool)
        for row in c:
            pidx = ((row & ((1 << 30) - 1)) - 1).clamp(min=0)
            q = tuple(hf._half(t.index_select(0, pidx)) for t in pxy)
            acc, e = hf.jac_madd(f, acc, q, ((row >> 30) & 1) != 0, row != 0)
            kexc |= e
    assert _equal(got, want) and torch.equal(exc, wexc)
    assert _equal(tuple(map(hf._pack, acc)), want) and torch.equal(kexc.to(torch.int32), wexc)
    assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    table = [(zero, zero) if pt is None else pt for pt in pts]
    fj = _emitter(env16, "fold", g2)
    jacc = _jax_cols([(one, one, zero)] * lanes, 3, g2, env16)
    jexc = np.zeros(lanes, bool)
    for row in codes:
        pidx = np.maximum((row & ((1 << 30) - 1)) - 1, 0)
        q = _jax_cols([table[k] for k in pidx], 2, g2, env16)
        jacc, e = env16["pf"]._jac_madd(fj, jacc, q, jnp.asarray(((row >> 30) & 1).astype(bool)),
                                        jnp.asarray(row != 0))
        jexc |= np.asarray(e).astype(bool)
    assert _equal(got, tuple(_from_jax(t, g2) for t in jacc))
    assert exc.tolist() == jexc.astype(int).tolist()


def _double_g2_warps(p):
    """One G2 doubling as jac_double_warps (csrc/curve.cuh) schedules it for
    a launch of at most 32 lanes: its 16 Fq products in 4 rounds of 4, warp
    w taking product w of each round for all the lanes, over the current
    hopper_field.HALF["fq"]."""
    f = hf.HALF["fq"]

    def c(v):
        return v[..., 0, :], v[..., 1, :]

    def fq2(c0, c1):
        return torch.stack([c0, c1], dim=-2)

    def rnd(*pairs):  # one round: 4 products, one multiply each
        assert len(pairs) == 4
        return [f.mul(a, b) for a, b in pairs]

    add, sub = f.add, f.sub
    (x0, x1), (y0, y1), (z0, z1) = c(p[0]), c(p[1]), c(p[2])
    t = rnd((add(x0, x1), sub(x0, x1)), (x0, x1), (add(y0, y1), sub(y0, y1)), (y0, y1))
    a, b = (t[0], add(t[1], t[1])), (t[2], add(t[3], t[3]))
    u = (add(x0, b[0]), add(x1, b[1]))
    t = rnd((add(*b), sub(*b)), b, (add(*u), sub(*u)), u)
    cc = (t[0], add(t[1], t[1]))
    d = [sub(s, add(ai, ci)) for s, ai, ci in zip((t[2], add(t[3], t[3])), a, cc)]
    d = [add(v, v) for v in d]
    e = [add(add(ai, ai), ai) for ai in a]
    v = (add(y0, y0), add(y1, y1))
    t = rnd((add(*e), sub(*e)), tuple(e), (v[0], z0), (v[1], z1))
    ff, zt = (t[0], add(t[1], t[1])), (t[2], t[3])
    x3 = [sub(fi, add(di, di)) for fi, di in zip(ff, d)]
    g = [sub(di, xi) for di, xi in zip(d, x3)]
    t = rnd((add(*v), add(z0, z1)), (e[0], g[0]), (e[1], g[1]), (add(*e), add(*g)))
    c8 = [add(ci, ci) for ci in cc]
    c8 = [add(ci, ci) for ci in c8]
    c8 = [add(ci, ci) for ci in c8]
    m = (sub(t[1], t[2]), sub(t[3], add(t[1], t[2])))
    return (fq2(*x3), fq2(*[sub(mi, ci) for mi, ci in zip(m, c8)]),
            fq2(sub(zt[0], zt[1]), sub(t[0], add(zt[0], zt[1]))))


@pytest.mark.parametrize("lanes", LANES)
def test_g2_double_on_the_tile_matches_the_fold_pallas_double(env16, lanes):
    """k_double<Fq2, MulFoldMma>'s data flow: two G2 doublings over an Fq2
    whose every Karatsuba product is a tile multiply, and (for launches of
    at most 32 lanes, here at any width) jac_double_warps' schedule of the
    16 products in 4 rounds, canonical infinity (lane 0) included: the
    plain doubling's limbs and the JAX fold formula's (``_jac_double``
    through ``Fq2Emit(FqEmitFold)``)."""
    p, *_ = special_lanes(True, lanes, random.Random(90 + lanes))
    P = _port(p, 3)
    want = hf.double_plain(True, P, 2)
    with _tile_fq():
        assert isinstance(hf._field(True), TileFq2)
        got = hf.double_plain(True, P, 2)
        warps = tuple(map(hf._half, P))
        for _ in range(2):
            warps = _double_g2_warps(warps)
    assert _equal(got, want) and _equal(tuple(map(hf._pack, warps)), want)
    assert not got[2][0].any()
    assert _equal(got, _jax_double(env16, p, 2, g2=True))


def _add_shift_converged(coords, shift: int, g2: bool = False):
    """One suffix round over a (rows, bw, L) grid (G2: (rows, bw, 2, L)) as
    the converged k_add_shift<Fq, Called<MulFoldMma>> (G2: k_add_shift<Fq2,
    MulFoldMma>) runs it, over the current hopper_field.HALF["fq"] (G2:
    HALF_FQ2): the rows * bw lanes flattened and padded to whole warps of 32
    with lane n - 1 (lane_in); each lane's partner in[i + shift] where i %
    bw + shift < bw, else canonical infinity; a warp none of whose lanes has
    a partner keeps p (infinity where p is infinite); the others run
    jac_add_select: the generic add, the doubling on the warps with a same
    lane (equal finite operands), then the selects in _jac_add's order.  ->
    (coords, warps that took the doubling)."""
    rows, bw = coords[0].shape[:2]
    tail = tuple(coords[0].shape[2:])
    n, W = rows * bw, fold_mul.TILE_LANES
    nw = -(-n // W)
    f = hf._field(g2)
    idx = torch.arange(nw * W).clamp(max=n - 1)
    partner = idx % bw + shift < bw
    k = torch.where(partner, idx + shift, idx)
    inf = hf._infinity(g2, (nw * W,), "cpu")
    flat = tuple(c.reshape((n,) + tail) for c in coords)
    p = tuple(hf._half(c[idx]) for c in flat)
    has = partner.reshape((-1,) + (1,) * len(tail))
    q = tuple(hf._half(torch.where(has, c[k], i)) for c, i in zip(flat, inf))
    p_inf, q_inf = f.is_zero(p[2]), f.is_zero(q[2])
    out = tuple(f.select(p_inf, i, c) for i, c in zip(map(hf._half, inf), p))  # the skipped warps' result
    live = torch.nonzero(partner.reshape(nw, W).any(dim=1).repeat_interleave(W)).flatten()
    dbl_warps = 0
    if live.numel():
        pl, ql = tuple(c[live] for c in p), tuple(c[live] for c in q)
        add, h, rr = hf._jac_add_generic(f, pl, ql)
        h_zero, r_zero = f.is_zero(h), f.is_zero(rr)
        pl_inf, ql_inf = p_inf[live], q_inf[live]
        same = h_zero & r_zero & ~pl_inf & ~ql_inf
        warp_same = same.reshape(-1, W).any(dim=1)
        dbl_warps = int(warp_same.sum())
        if dbl_warps:
            d = torch.nonzero(warp_same.repeat_interleave(W)).flatten()
            dbl = hf.jac_double(f, tuple(c[d] for c in pl))
            add = tuple(a.index_put((d,), f.select(same[d], x, a[d])) for a, x in zip(add, dbl))
        one = f.one_like(pl[0])
        opposite = h_zero & ~r_zero & ~pl_inf & ~ql_inf
        add = tuple(f.select(opposite, i, a) for i, a in zip((one, one, f.zero_like(one)), add))
        add = tuple(f.select(pl_inf, b, a) for b, a in zip(ql, add))
        add = tuple(f.select(ql_inf & ~pl_inf, b, a) for b, a in zip(pl, add))
        out = tuple(o.index_put((live,), a) for o, a in zip(out, add))
    return tuple(hf._pack(c[:n]).reshape(coords[0].shape) for c in out), dbl_warps


# (g2, bw, shift): in G1 a ragged 3 x 16 grid (48 lanes, the last warp half
# padding) at every shift 1 .. bw / 2, and a 1 x 64 row at shift 32, whose
# second warp has no partner (ids as before G2 joined); in G2 the same grids
# at shifts 1, 2 (the doubling), 4 (opposite points) and 32
SHIFT_CASES = [pytest.param(False, 16, s, id=f"16-{s}") for s in range(1, 9)] + [
    pytest.param(False, 64, 32, id="64-32")] + [
    pytest.param(True, bw, s, id=f"g2-{bw}-{s}") for bw, s in ((16, 1), (16, 2), (16, 4), (64, 32))]


@pytest.mark.parametrize("g2,bw,shift", SHIFT_CASES)
def test_suffix_round_on_the_tile_matches_the_fold_pallas_add(env16, g2, bw, shift):
    """The converged suffix round with the tile's multiply (G2: over
    TileFq2) on testing.shift_grid (row 0: equal operands at shift 1, the
    same limbs at shift 2, opposite points at shift 4, canonical infinity,
    infinity with random x and y, an infinite lane bw - 1):
    add_shift_plain's limbs and the JAX fold formula's
    ``_jac_add(complete=True)`` on the rolled partners; the doubling taken
    by warp 0 alone where row 0 has equal operands (shifts 1 and 2), by
    none elsewhere."""
    rows = 48 // bw if bw == 16 else 1
    pts = shift_grid(g2, rows, bw, random.Random(140 + bw + shift + 3 * g2))
    coords = tuple(c.reshape((rows, bw) + tuple(c.shape[1:])) for c in _port(pts, 3))
    want = hf.add_shift_plain(g2, coords, shift)
    with _tile_fq():
        assert isinstance(hf._field(g2), TileFq2 if g2 else TileFq)
        got, dbl_warps = _add_shift_converged(coords, shift, g2)
    assert _equal(got, want)
    assert dbl_warps == (1 if shift in (1, 2) else 0)
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    partners = [pts[i + shift] if i % bw + shift < bw else (one, one, zero) for i in range(rows * bw)]
    f = _emitter(env16, "fold", g2)
    jout = env16["pf"]._jac_add(f, _jax_cols(pts, 3, g2, env16), _jax_cols(partners, 3, g2, env16),
                                complete=True)
    assert _equal(tuple(c.reshape((rows * bw,) + tuple(c.shape[2:])) for c in got),
                  tuple(_from_jax(c, g2) for c in jout))


def _fold_emitter_eager(env):
    """The JAX package's fold emitter (``FqEmitFold``, its matrix bound as
    ``_fold_inputs`` binds it) run op by op: one complete add costs about a
    second so, against 37-47 s for the first compilation of
    ``_emitter``'s jitted multiply."""
    pf = env["pf"]
    e = pf._make_emit(env["params"].fq_spec(), "fold")
    extras, _specs, bind = pf._fold_inputs(e)
    bind(extras[0])
    return e


def _add_g1_warps(p, q):
    """One G1 complete add over n lanes of (n, L) coordinates as k_add's
    narrow form runs it (jac_add_warps, csrc/curve.cuh), over the current
    hopper_field.HALF["fq"]: the lanes in blocks of 32, the last padded
    with lane n - 1; the 16 Fq products in 5 rounds by their dependences
    (warp w of a block taking product w of a round, one tile multiply over
    the block's lanes); the doubling's 7 in 3 rounds on the blocks where a
    lane has equal finite operands (a block-uniform test); then
    _jac_add's selects.  -> (coords, blocks that took the doubling)."""
    f = hf.HALF["fq"]
    n, W = p[0].shape[0], fold_mul.TILE_LANES
    nb = -(-n // W)
    idx = torch.arange(nb * W).clamp(max=n - 1)
    (px, py, pz), (qx, qy, qz) = (tuple(hf._half(c[idx]) for c in pt) for pt in (p, q))

    def rnd(*pairs):  # one round: at most 4 products, one multiply each
        assert len(pairs) <= 4
        return [f.mul(a, b) for a, b in pairs]

    z1z1, z2z2, yz1, yz2 = rnd((pz, pz), (qz, qz), (py, qz), (qy, pz))
    u1, u2, s1, s2 = rnd((px, z2z2), (qx, z1z1), (yz1, z2z2), (yz2, z1z1))
    h = f.sub(u2, u1)
    rr = f.sub(s2, s1)
    rr = f.add(rr, rr)
    h2, zs = f.add(h, h), f.add(pz, qz)
    i, r2, zsq = rnd((h2, h2), (rr, rr), (zs, zs))
    j, v, z3 = rnd((h, i), (u1, i), (f.sub(zsq, f.add(z1z1, z2z2)), h))
    x3 = f.sub(f.sub(r2, j), f.add(v, v))
    s1j, m = rnd((s1, j), (rr, f.sub(v, x3)))
    out = (x3, f.sub(m, f.add(s1j, s1j)), z3)
    p_inf, q_inf, h_zero, r_zero = f.is_zero(pz), f.is_zero(qz), f.is_zero(h), f.is_zero(rr)
    same = h_zero & r_zero & ~p_inf & ~q_inf
    blocks = same.reshape(nb, W).any(dim=1)
    if blocks.any():
        d = torch.nonzero(blocks.repeat_interleave(W)).flatten()
        x, y, z = px[d], py[d], pz[d]
        a, b, dz = rnd((x, x), (y, y), (f.add(y, y), z))
        e, xb = f.add(f.add(a, a), a), f.add(x, b)
        c, sq, ff = rnd((b, b), (xb, xb), (e, e))
        dd = f.sub(sq, f.add(a, c))
        dd = f.add(dd, dd)
        dx3 = f.sub(ff, f.add(dd, dd))
        (em,) = rnd((e, f.sub(dd, dx3)))
        c8 = f.add(c, c)
        c8 = f.add(c8, c8)
        c8 = f.add(c8, c8)
        dbl = (dx3, f.sub(em, c8), dz)
        out = tuple(o.index_put((d,), f.select(same[d], dv, o[d])) for o, dv in zip(out, dbl))
    one = f.one_like(px)
    opposite = h_zero & ~r_zero & ~p_inf & ~q_inf
    out = tuple(f.select(opposite, c, o) for c, o in zip((one, one, f.zero_like(one)), out))
    out = tuple(f.select(p_inf, c, o) for c, o in zip((qx, qy, qz), out))
    out = tuple(f.select(q_inf & ~p_inf, c, o) for c, o in zip((px, py, pz), out))
    return tuple(hf._pack(c[:n]) for c in out), int(blocks.sum())


# the JAX fold formula's complete add on _ADD_LANES' inputs, computed once
_ADD_JAX: dict = {}
_ADD_LANES = LANES[-1]


@pytest.mark.parametrize("lanes", LANES)
def test_add_on_the_tile_matches_the_fold_pallas_add(env16, lanes):
    """The complete G1 add with the tile's multiply, in both forms of the
    converged k_add<Fq, Called<MulFoldMma>>: jac_add_select (every multiply
    on every lane, then the selects: hopper_field.jac_add over TileFq) and
    the narrow form's schedule (_add_g1_warps), on testing.special_lanes
    (inf + q, p + inf, inf + inf, p + p with the same limbs and with
    another Z, p + (-p): h = 0 with r != 0) and lane 70 = p + p alone in
    the third block: the plain add's limbs and the JAX package's
    ``_jac_add(complete=True)`` through the fold emitter, run once at 71
    lanes (the 16-lane case takes its first 16 lanes)."""
    p, q, *_ = special_lanes(False, _ADD_LANES, random.Random(150))
    q[_ADD_LANES - 1] = p[_ADD_LANES - 1]
    P, Q = (tuple(c[:lanes] for c in _port(pts, 3)) for pts in (p, q))
    want = hf.add_plain(False, P, Q)
    with _tile_fq():
        f = hf._field(False)
        assert isinstance(f, TileFq)
        got = tuple(map(hf._pack, hf.jac_add(f, tuple(map(hf._half, P)), tuple(map(hf._half, Q)))))
        narrow, blocks = _add_g1_warps(P, Q)
    assert _equal(got, want) and _equal(narrow, want)
    assert blocks == (1 if lanes <= 64 else 2)
    assert not got[2][2].any() and not got[2][5].any()
    if not _ADD_JAX:
        jout = env16["pf"]._jac_add(_fold_emitter_eager(env16), _jax_cols(p, 3, False, env16),
                                    _jax_cols(q, 3, False, env16), complete=True)
        _ADD_JAX["out"] = tuple(_from_jax(c, False) for c in jout)
    assert _equal(got, tuple(c[:lanes] for c in _ADD_JAX["out"]))


# the fold unit's tensor-core instances as the profiler (demangled) and
# ptxas / cuobjdump (mangled) name them, called and inlined, and a fold
# instance on the dp4a fold beside them (the G1 distinct add)
_NAMES = {
    "(anonymous namespace)::k_madd_scan<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)":
        "g1_madd_scan_fold",
    "(anonymous namespace)::k_double<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)": "g1_double_fold",
    "(anonymous namespace)::k_double<Fp<FqParams>, MulFoldMma>(unsigned int const*, ...)": "g1_double_fold",
    "(anonymous namespace)::k_add_shift<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)":
        "g1_add_shift_fold",
    "(anonymous namespace)::k_double<Fq2, MulFoldMma>(unsigned int const*, ...)": "g2_double_fold",
    "(anonymous namespace)::k_add_shift<Fq2, MulFoldMma>(unsigned int const*, ...)": "g2_add_shift_fold",
    "(anonymous namespace)::k_madd_scan<Fq2, MulFoldMma>(unsigned int const*, ...)": "g2_madd_scan_fold",
    "(anonymous namespace)::k_add<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)": "g1_add_fold",
    "(anonymous namespace)::k_mont_inv<FrParams, MulFoldMmaOf<FrParams> >(unsigned int const*, unsigned int*, long long)":
        "mont_inv_fr_fold",
    "(anonymous namespace)::k_add_distinct<Fp<FqParams>, Called<MulFold> >(unsigned int const*, ...)":
        "g1_add_distinct_fold",
}
_SCAN = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN11k_madd_scanI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_PKiixPjSC_SC_Pi"
_DBL = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_S9_PjSA_SA_xi"
_DBL_INLINE = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI2FpI8FqParamsE10MulFoldMmaEEvPKjS7_S7_PjS8_S8_xi"
_SHIFT = ("_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN11k_add_shiftI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_S9_"
          "PjSA_SA_xii")
_G2_DBL = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI3Fq210MulFoldMmaEEvPKjS4_S4_PjS5_S5_xi"
_G2_SHIFT = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN11k_add_shiftI3Fq210MulFoldMmaEEvPKjS4_S4_PjS5_S5_xii"
_G2_SCAN = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN11k_madd_scanI3Fq210MulFoldMmaEEvPKjS4_PKiixPjS7_S7_Pi"
_G1_ADD = ("_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN5k_addI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_S9_S9_"
           "S9_S9_PjSA_SA_x")
_INV_FR = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN10k_mont_invI8FrParams12MulFoldMmaOfIS2_EEEvPKjPjx"
_G1_ADD_DISTINCT = ("_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN14k_add_distinctI2FpI8FqParamsE6CalledI7MulFoldEEEvPKj"
                    "S9_S9_S9_S9_S9_PjSA_SA_x")
_FQ_MUL_MMA = "_Z11fq_mul_callI10MulFoldMmaE2FpI8FqParamsES3_S3_"
_MUL_MMA = "_Z10mul_calledI10MulFoldMma8FqParamsE2FpIT0_ES4_S4_"


def test_mma_instances_keep_their_names():
    """The profiler's and ptxas's names of the tensor-core instances map to
    g1_madd_scan_fold / g1_double_fold / g1_add_shift_fold /
    g2_double_fold / g2_madd_scan_fold / g2_add_shift_fold / g1_add_fold /
    mont_inv_fr_fold (the mode's name holds MulFold; the Fr chain's is
    MulFoldMmaOf<FrParams>), a fold instance on the dp4a fold (the G1
    distinct add) keeps its own name, and the called multiplies (G1's
    mul_called, G2's fq_mul_call) are no kernels of the kernels line."""
    _root_on_path()
    import chip_smoke

    for name, want in _NAMES.items():
        assert chip_smoke.kernel_key(name) == want, name
    assert _build.short_name(_SCAN) == "k_madd_scan<FqParams,Called<MulFoldMma>>"
    assert _build.short_name(_DBL_INLINE) == "k_double<FqParams,MulFoldMma>"
    assert _build.short_name(_SHIFT) == "k_add_shift<FqParams,Called<MulFoldMma>>"
    assert _build.short_name(_G2_DBL) == "k_double<Fq2,MulFoldMma>"
    assert _build.short_name(_G2_SCAN) == "k_madd_scan<Fq2,MulFoldMma>"
    assert _build.short_name(_G2_SHIFT) == "k_add_shift<Fq2,MulFoldMma>"
    assert _build.short_name(_G1_ADD) == "k_add<FqParams,Called<MulFoldMma>>"
    assert _build.short_name(_INV_FR) == "k_mont_inv<FrParams,MulFoldMmaOf>"
    assert _build.short_name(_G1_ADD_DISTINCT) == "k_add_distinct<FqParams,Called<MulFold>>"
    names = (_SCAN, _DBL, _DBL_INLINE, _SHIFT, _G2_DBL, _G2_SCAN, _G2_SHIFT, _G1_ADD, _INV_FR, _G1_ADD_DISTINCT)
    assert [chip_smoke.instance_name(_build.short_name(n)) for n in names] == [
        "g1_madd_scan_fold", "g1_double_fold", "g1_double_fold", "g1_add_shift_fold", "g2_double_fold",
        "g2_madd_scan_fold", "g2_add_shift_fold", "g1_add_fold", "mont_inv_fr_fold", "g1_add_distinct_fold"]
    assert _build.short_name(_MUL_MMA) == "mul_called<MulFoldMma,FqParams>"
    assert _build.short_name(_FQ_MUL_MMA) == "fq_mul_call<MulFoldMma,FqParams>"
    assert chip_smoke.instance_name(_build.short_name(_MUL_MMA)) is None
    assert chip_smoke.instance_name(_build.short_name(_FQ_MUL_MMA)) is None
    # MMA_KERNELS names curve_fold.cu's kMmaKernels table in its order (mma_info indexes the table by it)
    table = re.findall(r"\(k_(madd_scan|double|add_shift|add|mont_inv)<(Fq2?|FrParams), Mode(?:G[12]|Fr)Mma>\)",
                       (_build.CSRC / "curve_fold.cu").read_text())
    assert hf.MMA_KERNELS == tuple("mont_inv_fr_fold" if f == "FrParams" else f"{'g2' if f == 'Fq2' else 'g1'}_{k}_fold"
                                   for k, f in table)
    assert len(hf.MMA_KERNELS) == 8 and set(hf.MMA_KERNELS) <= set(hf.KERNELS)
    assert {"vs_curve_fold_mma_upload", "vs_curve_fold_mma_info"} <= set(_build.UNITS["curve_fold.cu"])


# cuobjdump -sass of the curve library as the card's toolkit writes it: each
# kernel's code holds the device functions it calls out of line (Called<M>'s
# multiply) behind their CALL targets
_SASS = f"""
	code for sm_90a
		Function : {_SCAN}
        /*0100*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0110*/                   CALL.REL.NOINC 0x140 ;
        /*0120*/              @!P0 BRA 0x100 ;
        /*0130*/                   EXIT ;
        /*0140*/                   FFMA R21, R145, R53, R68 ;
        /*0150*/                   LDSM.16.M88.4 R40, [R2] ;
        /*0160*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0170*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0180*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_DBL}
        /*0200*/                   CALL.REL.NOINC 0x230 ;
        /*0210*/                   CALL.REL.NOINC 0x230 ;
        /*0220*/                   EXIT ;
        /*0230*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0240*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_SHIFT}
        /*0300*/              @!P0 BRA 0x320 ;
        /*0310*/                   CALL.REL.NOINC 0x340 ;
        /*0320*/                   EXIT ;
        /*0340*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0350*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0360*/                   IMMA.16832.U8.S8 R16, R40.ROW, R52.COL, R16 ;
        /*0370*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_G2_DBL}
        /*0400*/                   CALL.REL.NOINC 0x420 ;
        /*0410*/                   EXIT ;
        /*0420*/                   FFMA R1, R2, R3, R4 ;
        /*0430*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0440*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_G2_SCAN}
        /*0500*/                   CALL.REL.NOINC 0x530 ;
        /*0510*/              @!P0 BRA 0x500 ;
        /*0520*/                   EXIT ;
        /*0530*/                   FFMA R1, R2, R3, R4 ;
        /*0540*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0550*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0560*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_G2_SHIFT}
        /*0600*/                   CALL.REL.NOINC 0x620 ;
        /*0610*/                   EXIT ;
        /*0620*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0630*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_G1_ADD}
        /*0700*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0710*/                   CALL.REL.NOINC 0x730 ;
        /*0720*/                   EXIT ;
        /*0730*/                   FFMA R1, R2, R3, R4 ;
        /*0740*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0750*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_INV_FR}
        /*0800*/                   FFMA R1, R2, R3, R4 ;
        /*0810*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0820*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0830*/              @!P0 BRA 0x800 ;
        /*0840*/                   EXIT ;
		Function : {_G1_ADD_DISTINCT}
        /*0900*/                   CALL.REL.NOINC 0x920 ;
        /*0910*/                   EXIT ;
        /*0920*/                   FFMA R1, R2, R3, R4 ;
        /*0930*/                   IDP.4A.U8.S8 R4, R8, c[0x3][0x0], R4 ;
        /*0940*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_counts_hold_the_called_multiply():
    """[sass] counts a kernel's instructions with those of the multiply it
    calls out of line, which cuobjdump lists inside the kernel's code: the
    tensor-core instances (the G2 doubling, scan and suffix round, the G1
    complete add and the Fr chain among them) show IMMA and no IDP, the G1
    fold distinct add the dp4a of mul_fold, each under its kernels-line
    name."""
    _root_on_path()
    import chip_smoke

    assert chip_smoke.sass_counts(_SASS) == {
        "g1_madd_scan_fold": {"IMMA": 2, "IDP": 0, "FFMA": 1, "all": 9},
        "g1_double_fold": {"IMMA": 1, "IDP": 0, "FFMA": 0, "all": 5},
        "g1_add_shift_fold": {"IMMA": 3, "IDP": 0, "FFMA": 0, "all": 7},
        "g2_double_fold": {"IMMA": 1, "IDP": 0, "FFMA": 1, "all": 5},
        "g2_madd_scan_fold": {"IMMA": 2, "IDP": 0, "FFMA": 1, "all": 7},
        "g2_add_shift_fold": {"IMMA": 1, "IDP": 0, "FFMA": 0, "all": 4},
        "g1_add_fold": {"IMMA": 1, "IDP": 0, "FFMA": 1, "all": 6},
        "mont_inv_fr_fold": {"IMMA": 2, "IDP": 0, "FFMA": 1, "all": 5},
        "g1_add_distinct_fold": {"IMMA": 0, "IDP": 1, "FFMA": 1, "all": 5},
    }
    assert all(counts["IMMA"] and not counts["IDP"] for k, counts in chip_smoke.sass_counts(_SASS).items()
               if k in hf.MMA_KERNELS)
    assert set(hf.MMA_KERNELS) <= set(chip_smoke.sass_counts(_SASS))


def test_fold_launcher_uploads_the_b_operand_once_a_card(monkeypatch):
    """hopper_field._launcher puts the fold unit's matrices in place before
    a fold launcher is handed out, once per card: the dp4a fold's packed
    matrix of Fq (the unit's dp4a instances are all Fq's), and the
    tensor-core fold's B operands (fold_mul.mma_operand, N x K bytes) of Fq
    and of Fr, which the Fr inversion chain reads; loop uploads nothing."""
    calls = []

    def recorder(name):
        def upload(field, ptr, n):
            calls.append((name, field, n))
            return 0

        upload.__name__ = name
        return upload

    lib = type("Lib", (), {n: staticmethod(recorder(n)) for n in ("vs_curve_fold_upload", "vs_curve_fold_mma_upload")})
    lib.vs_double_fold, lib.vs_double = "fold launcher", "loop launcher"
    monkeypatch.setattr(hf, "_lib", lambda: lib)
    monkeypatch.setattr(hf, "_fold_uploaded", set())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for index in (0, 0, 1):
        assert hf._launcher("vs_double", "fold", torch.device("cuda", index)) == "fold launcher"
    assert hf._launcher("vs_double", "loop", torch.device("cuda", 2)) == "loop launcher"
    one_card = [("vs_curve_fold_upload", 0, fold_mul.packed_matrix(lb.FQ).size),
                ("vs_curve_fold_mma_upload", 0, fold_mul.mma_operand(lb.FQ).size),
                ("vs_curve_fold_mma_upload", 1, fold_mul.mma_operand(lb.FR).size)]
    assert calls == one_card * 2
    assert fold_mul.mma_operand(lb.FQ).size == 56 * 288 and fold_mul.mma_operand(lb.FR).size == 40 * 192
