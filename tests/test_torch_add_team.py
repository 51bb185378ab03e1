"""The team schedule of K3 in G2 and K1's broadcast operand, on the CPU.

``ops/add_team.py`` cuts the complete add into the phases the team kernel
``csrc/add_team.cu`` executes; ``add_team_plain`` runs the same table on
the plain Fq arithmetic.  It must equal the Pallas formula
``pallas_field._jac_add(complete=True)`` (its ``FqEmit``/``Fq2Emit`` body
run eagerly in the 16-bit layout, as tests/test_torch_curve.py runs it)
limb for limb on every special lane, and the committed table header must
be the one the schedule writes.  K1 (``hopper_field.mont_mul``) reads an
operand broadcast over the batch in place at ``i % nb``; on the CPU the
wrapper computes the same ``nb`` and gathers with it, and the product must
equal the materialised one and the Pallas multiply's body on each of the
vote path's shapes.  Integer arithmetic throughout: tolerance zero.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import add_team as at
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import TEAM_EXTRA, team_add_lanes, torch_threads


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


def _port(points):
    return tuple(lb.ints_to_tensor([pt[k] for pt in points], lb.FQ) for k in range(3))


def _jax_cols(points, g2, env):
    """Host ints -> the emitter layout: (L16, B) per Fq coordinate."""
    spec, jlb = env["params"].fq_spec(), env["lb"]

    def cols(vals):
        return np.asarray(jlb.ints_to_mont_limbs(vals, spec)).T

    out = []
    for k in range(3):
        vals = [pt[k] for pt in points]
        out.append((cols([v[0] for v in vals]), cols([v[1] for v in vals])) if g2 else cols(vals))
    return tuple(out)


def _from_jax(coord, g2):
    if g2:
        return convert.from_jax_limbs(np.stack([np.asarray(coord[0]).T, np.asarray(coord[1]).T], axis=1))
    return convert.from_jax_limbs(np.asarray(coord).T)


def test_g2_schedule_levels_and_critical_path():
    s = at.schedule(True)
    at.check(s)
    assert at.ADD_TEAM_LEVELS == {"pre": [12, 12], "gen": [7, 6, 6], "dbl": [7, 6, 3]}
    assert sum(at.ADD_TEAM_LEVELS["pre"] + at.ADD_TEAM_LEVELS["gen"]) == 43
    # one Fq multiply a level on the critical path: 5 in sequence, 3 for the doubling
    assert len(s.levels("pre") + s.levels("gen")) == 5 and len(s.levels("dbl")) == 3
    assert max(len(ops) for _m, ops in s.phases) <= at.TEAM == 16
    # every multiply phase holds products only, every other phase adds and subtracts
    assert all(all((op[0] == at.MUL) == is_mul for op in ops) for is_mul, ops in s.phases)
    # slots: the 12 inputs and the two constants first, within a byte's index
    assert (s.one, s.zero) == (12, 13) and s.slots < 256
    assert s.out["p"] == tuple(range(6)) and s.out["q"] == tuple(range(6, 12))
    assert s.out["inf"] == (12, 13, 12, 13, 13, 13)


def test_g1_schedule_levels():
    s = at.schedule(False)
    at.check(s)
    assert {k: s.levels(k) for k in ("pre", "gen", "dbl")} == {"pre": [5, 4], "gen": [3, 2, 2], "dbl": [3, 3, 1]}


def test_committed_header_is_the_schedule():
    assert at.HEADER.read_text() == at.render_header()


def test_check_rejects_a_phase_that_writes_what_it_reads():
    s = at.schedule(True)
    k = next(i for i, (_m, ops) in enumerate(s.phases) if len(ops) > 1)
    is_mul, ops = s.phases[k]
    bad = list(s.phases)
    kind, _dst, a, b = ops[1]
    bad[k] = (is_mul, [ops[0], (kind, ops[0][2], a, b)] + list(ops[2:]))
    with pytest.raises(ValueError):
        at.check(at.Schedule(**{**s.__dict__, "phases": tuple(bad)}))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_team_plain_matches_pallas_formula(env16, g2):
    n = 16 + TEAM_EXTRA
    p, q = team_add_lanes(g2, n, random.Random(41 + g2), period=n)
    out = at.add_team_plain(g2, _port(p), _port(q))
    pf = env16["pf"]
    e = pf.FqEmit(env16["params"].fq_spec())
    jout = pf._jac_add(pf.Fq2Emit(e) if g2 else e, _jax_cols(p, g2, env16), _jax_cols(q, g2, env16),
                       complete=True)
    for got, exp in zip(out, jout):
        assert torch.equal(got, _from_jax(exp, g2))
    assert all(torch.equal(a, b) for a, b in zip(out, hf.add_plain(g2, _port(p), _port(q))))
    # the special lanes: inf + q, p + inf, inf + inf, p + p, p + p, p + (-p),
    # then (0, 0, 0) as p, as q, as both, random-(x, y) infinity as p, as q
    P, Q_ = _port(p), _port(q)
    one = lb.ints_to_tensor([(1, 0)] if g2 else [1], lb.FQ)[0]
    for lane, want in ((0, Q_), (1, P), (6, Q_), (7, P), (8, Q_), (9, Q_), (10, P)):
        assert all(torch.equal(o[lane], w[lane]) for o, w in zip(out, want)), lane
    for lane in (2, 5):
        assert torch.equal(out[0][lane], one) and torch.equal(out[1][lane], one) and not out[2][lane].any()
    dbl = hf.double_plain(g2, P)
    for lane in (3, 4):
        assert all(torch.equal(o[lane], d[lane]) for o, d in zip(out, dbl)), lane


def _fr(shape, rnd):
    n = int(np.prod(shape)) if shape else 1
    N = lb.FR.modulus
    vals = [0, 1, N - 1][:n] + [rnd.randrange(N) for _ in range(max(n - 3, 0))]
    return lb.ints_to_tensor(vals, lb.FR).reshape(tuple(shape) + (lb.FR.num_limbs,))


# (a's leading shape, b's, the nb the kernel reads b with): the vote path's
# K1 calls at small size — the COO products (groth16._abc_h_w: c2m[None]
# first), the R1CS check, the radix-2 NTT's coset powers, H's zh_coset_inv
# and from_mont's constant, the matmul NTT's twiddle (bf, n2, n1) against
# t12 — and two broadcasts the kernel cannot read in place
PATH_SHAPES = [
    ((1, 7), (3, 7), 7),
    ((3, 8), (3, 8), 24),
    ((3, 8), (8,), 8),
    ((3, 8), (), 1),
    ((2, 4, 2), (4, 2), 8),
    ((3, 2, 4, 2), (4, 1), 48),
    ((3, 1, 8), (1, 4, 1), 96),
]


@pytest.mark.parametrize("sa,sb,nb", PATH_SHAPES, ids=[f"{a}x{b}" for a, b, _ in PATH_SHAPES])
def test_k1_broadcast_operand_matches_materialized_and_pallas(env16, sa, sb, nb):
    rnd = random.Random(hash((sa, sb)) & 0xFFFF)
    a, b = _fr(sa, rnd), _fr(sb, rnd)
    x, y, shape, n, got_nb = hf.mul_operands(a, b)
    assert (got_nb, n) == (nb, int(np.prod(shape[:-1]))) and x.shape == (n, 8) and y.shape == (nb, 8)
    got = hf.mont_mul("fr", a, b)
    ab = torch.broadcast_tensors(a, b)
    assert torch.equal(got, hf.mont_mul_plain("fr", *(t.contiguous() for t in ab)))
    # lane i of the product is x[i] * y[i % nb]
    assert torch.equal(got.reshape(n, 8), hf.mont_mul_plain("fr", x, y[torch.arange(n) % nb]))
    # the Pallas multiply's body on the operands mont_mul_pallas broadcasts
    pf, jlb = env16["pf"], env16["lb"]
    spec = env16["params"].fr_spec()

    def cols(t):
        return np.asarray(jlb.ints_to_mont_limbs(list(lb.tensor_to_ints(t.reshape(-1, 8), lb.FR)), spec)).T

    jout = pf.FqEmit(spec).mul(cols(ab[0]), cols(ab[1]))
    assert torch.equal(got.reshape(n, 8), convert.from_jax_limbs(np.asarray(jout).T))
