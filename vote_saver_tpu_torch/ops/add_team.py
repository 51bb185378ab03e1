"""The team schedule of K3 in G2: one lane's complete Jacobian add on a
team of TEAM threads (``csrc/add_team.cu``).

The complete add of ``hopper_field.jac_add`` is a DAG of Fq products and
Fq adds and subtracts.  ``schedule`` cuts it into phases: a *multiply
phase* holds up to TEAM independent Fq products (one a thread), a *linear
phase* up to TEAM independent adds or subtracts.  Every Fq value lives in a
numbered slot of the team's shared memory; a phase reads its operands from
slots and writes its results to slots no operand of the same phase reads,
so one ``__syncwarp`` between phases is the whole protocol.

Three sections of phases, as the kernel runs them:

  ``pre``  the generic formula up to h = u2 - u1 and rr = 2 (s2 - s1):
           multiply levels L1 (z1^2, z2^2, y1 z2, y2 z1, (z1 + z2)^2) and
           L2 (u1, u2, s1, s2);
  ``gen``  the rest of the generic formula: L3 ((2h)^2, the z3 product,
           rr^2), L4 (j, v), L5 (s1 j, rr (v - x3));
  ``dbl``  ``jac_double(p)`` from p's input slots, in three levels.

The whole team takes one branch per lane, with the select semantics of
``jac_add(complete=True)``: p infinite -> q; q infinite -> p (no phase
runs); otherwise ``pre``, then h = 0 and rr = 0 -> ``dbl``; h = 0 alone ->
canonical infinity (1, 1, 0); else ``gen``.  Over Fq2 a product is
Karatsuba's three Fq products and a square two, exactly as ``HalfField2``
and ``csrc/mul_modes.cuh`` compute them, so the G2 levels hold 12, 12, 7,
6, 6 Fq products: 5 on the critical path where the one-thread kernel runs
43 in sequence.

``ADD_TEAM_LEVELS`` is the G2 schedule; ``render_header`` writes it as
``csrc/add_team_g2.cuh``, the table the kernel executes
(``python -m vote_saver_tpu_torch.ops.add_team`` rewrites the file;
``tests/test_torch_add_team.py`` holds the committed file equal to it).
``add_team_plain`` executes a schedule on the plain Fq arithmetic of
``hopper_field``, phase by phase, every read of a phase before its writes.
The schedule is written over the coordinate field (``schedule(g2=False)``
gives G1's); only G2's is built into a kernel.
"""

from __future__ import annotations

import functools
import pathlib
from dataclasses import dataclass

import torch

TEAM = 16
MUL, ADD, SUB = 0, 1, 2
NO_OP = 0xFFFFFFFF  # a thread's op word in a phase where it idles
HEADER = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "add_team_g2.cuh"


class _Dag:
    """Fq values: ids 0 .. n_in - 1 are inputs, then one id per op
    (kind, a, b).  Equal ops are one value (add and multiply commute)."""

    def __init__(self, n_in: int):
        self.n_in = n_in
        self.ops: list[tuple[int, int, int]] = []
        self._memo: dict = {}

    def op(self, kind: int, a: int, b: int) -> int:
        if kind != SUB and a > b:
            a, b = b, a
        key = (kind, a, b)
        if key not in self._memo:
            self._memo[key] = self.n_in + len(self.ops)
            self.ops.append(key)
        return self._memo[key]

    def src(self, v: int):
        return self.ops[v - self.n_in] if v >= self.n_in else None


class _Elems:
    """Coordinate-field arithmetic on tuples of Fq value ids: one id (Fq)
    or two (Fq2, c0 first)."""

    def __init__(self, dag: _Dag, g2: bool):
        self.d, self.g2 = dag, g2

    def add(self, a, b):
        return tuple(self.d.op(ADD, x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.d.op(SUB, x, y) for x, y in zip(a, b))

    def mul(self, a, b):
        d = self.d
        if not self.g2:
            return (d.op(MUL, a[0], b[0]),)
        t0, t1 = d.op(MUL, a[0], b[0]), d.op(MUL, a[1], b[1])
        t2 = d.op(MUL, d.op(ADD, a[0], a[1]), d.op(ADD, b[0], b[1]))
        return (d.op(SUB, t0, t1), d.op(SUB, t2, d.op(ADD, t0, t1)))

    def sq(self, a):
        d = self.d
        if not self.g2:
            return (d.op(MUL, a[0], a[0]),)
        t0 = d.op(MUL, d.op(ADD, a[0], a[1]), d.op(SUB, a[0], a[1]))
        t1 = d.op(MUL, a[0], a[1])
        return (t0, d.op(ADD, t1, t1))


def _generic(E: _Elems, p, q):
    """``hopper_field._jac_add_generic``: ((x3, y3, z3), h, rr)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = E.sq(z1), E.sq(z2)
    u1, u2 = E.mul(x1, z2z2), E.mul(x2, z1z1)
    s1, s2 = E.mul(E.mul(y1, z2), z2z2), E.mul(E.mul(y2, z1), z1z1)
    h = E.sub(u2, u1)
    rr = E.sub(s2, s1)
    rr = E.add(rr, rr)
    i = E.sq(E.add(h, h))
    j, v = E.mul(h, i), E.mul(u1, i)
    x3 = E.sub(E.sub(E.sq(rr), j), E.add(v, v))
    s1j = E.mul(s1, j)
    y3 = E.sub(E.mul(rr, E.sub(v, x3)), E.add(s1j, s1j))
    z3 = E.mul(E.sub(E.sq(E.add(z1, z2)), E.add(z1z1, z2z2)), h)
    return (x3, y3, z3), h, rr


def _double(E: _Elems, p):
    """``hopper_field.jac_double``."""
    x1, y1, z1 = p
    a, b = E.sq(x1), E.sq(y1)
    c = E.sq(b)
    d = E.sub(E.sq(E.add(x1, b)), E.add(a, c))
    d = E.add(d, d)
    e = E.add(E.add(a, a), a)
    x3 = E.sub(E.sq(e), E.add(d, d))
    c8 = E.add(c, c)
    c8 = E.add(c8, c8)
    c8 = E.add(c8, c8)
    y3 = E.sub(E.mul(e, E.sub(d, x3)), c8)
    z3 = E.mul(E.add(y1, y1), z1)
    return (x3, y3, z3)


def _phases(dag: _Dag, roots) -> list[tuple[bool, list[int]]]:
    """The ops `roots` need, as [(is_multiply, [value id, ...])]: multiply
    phase k holds the products k multiplies deep; the linear ops k deep sit
    between multiply phases k and k + 1, list-scheduled into rounds of at
    most TEAM, longest remaining chain first."""
    need, stack = set(), list(roots)
    while stack:
        v = stack.pop()
        if v in need or dag.src(v) is None:
            continue
        need.add(v)
        stack.extend(dag.src(v)[1:])
    depth: dict = {}
    for v in sorted(need):  # an op's sources have smaller ids
        kind, a, b = dag.src(v)
        d = max(depth.get(a, 0), depth.get(b, 0))
        depth[v] = d + (kind == MUL)
    users: dict = {v: [] for v in need}
    for v in need:
        for s in set(dag.src(v)[1:]):
            if s in need:
                users[s].append(v)

    @functools.cache
    def tail(v):  # linear ops after v in its own segment, on the longest path
        nxt = [u for u in users[v] if dag.src(u)[0] != MUL and depth[u] == depth[v]]
        return 1 + max(map(tail, nxt), default=0) if dag.src(v)[0] != MUL else 0

    out = []
    for k in range(max(depth.values(), default=0) + 1):
        muls = sorted(v for v in need if depth[v] == k and dag.src(v)[0] == MUL)
        for s in range(0, len(muls), TEAM):
            out.append((True, muls[s : s + TEAM]))
        todo = {v for v in need if depth[v] == k and dag.src(v)[0] != MUL}
        while todo:
            ready = [v for v in todo if not any(s in todo for s in dag.src(v)[1:])]
            ready.sort(key=lambda v: (-tail(v), v))
            rnd = ready[:TEAM]
            out.append((False, sorted(rnd)))
            todo -= set(rnd)
    return out


def _alloc(dag, phases, slot_of: dict, keep: set, fixed: set):
    """Give each op of `phases` a slot.  `slot_of` maps the values already
    in slots (updated in place); values in `keep` are never freed; a slot
    is freed after the phase of its value's last read and reused from the
    next phase on, so no phase writes a slot that it reads.  Returns the
    phases as [(is_multiply, [(kind, dst, a, b), ...])]."""
    last: dict = {}
    for k, (_m, ops) in enumerate(phases):
        for v in ops:
            for s in dag.src(v)[1:]:
                last[s] = k
    used = set(slot_of.values()) | fixed
    out = []
    for k, (is_mul, ops) in enumerate(phases):
        enc = []
        for v in ops:
            kind, a, b = dag.src(v)
            free = next(s for s in range(len(used) + 1) if s not in used)
            used.add(free)
            slot_of[v] = free
            enc.append((kind, free, slot_of[a], slot_of[b]))
        out.append((is_mul, enc))
        for v, s in list(slot_of.items()):
            if v not in keep and last.get(v, k) == k:
                used.discard(s)
                del slot_of[v]
    return out


@dataclass(frozen=True)
class Schedule:
    """A complete add's team schedule.  Slots 0 .. 3C - 1 hold p (x, y, z,
    C Fq values each, c0 first), 3C .. 6C - 1 q, then the constants ONE
    (Montgomery 1) and ZERO; ``phases`` are [(is_multiply, [(kind, dst, a,
    b)])]; ``pre``/``gen``/``dbl`` are (begin, end) ranges of phases;
    ``out`` the 3C result slots of each outcome; ``h``/``rr`` the slots of
    h and rr after ``pre``."""

    comps: int
    slots: int
    one: int
    zero: int
    phases: tuple
    pre: tuple
    gen: tuple
    dbl: tuple
    out: dict
    h: tuple
    rr: tuple

    def levels(self, section: str) -> list[int]:
        """Fq products of each multiply phase of `section`: its critical
        path is one Fq multiply a level."""
        lo, hi = getattr(self, section)
        return [len(ops) for is_mul, ops in self.phases[lo:hi] if is_mul]


OUTCOMES = ("gen", "dbl", "p", "q", "inf")


@functools.cache
def schedule(g2: bool = True) -> Schedule:
    C = 2 if g2 else 1
    gd = _Dag(6 * C)
    ins = tuple(tuple(range(k * C, (k + 1) * C)) for k in range(6))
    (x3, y3, z3), h, rr = _generic(_Elems(gd, g2), ins[:3], ins[3:])
    gen_out = x3 + y3 + z3
    g_phases = _phases(gd, gen_out + h + rr)
    # the section boundary: the first multiply phase past L2
    mul_seen, cut = 0, len(g_phases)
    for k, (is_mul, _ops) in enumerate(g_phases):
        mul_seen += is_mul
        if is_mul and mul_seen == 3:
            cut = k
            break
    one, zero = 6 * C, 6 * C + 1
    fixed = {one, zero}
    p_vals = set(range(3 * C))
    pre_slots = {v: v for v in range(6 * C)}
    later = {s for _m, ops in g_phases[cut:] for v in ops for s in gd.src(v)[1:]}
    pre = _alloc(gd, g_phases[:cut], pre_slots, p_vals | later | set(h) | set(rr), fixed)
    h_slots, rr_slots = tuple(pre_slots[v] for v in h), tuple(pre_slots[v] for v in rr)
    gen_slots = {v: s for v, s in pre_slots.items() if v in later}
    gen = _alloc(gd, g_phases[cut:], gen_slots, set(gen_out), fixed)

    dd = _Dag(3 * C)
    dbl_out = sum(_double(_Elems(dd, g2), ins[:3]), ())
    dbl_slots = {v: v for v in range(3 * C)}
    # the slots that hold values of the pre section stay out of reach only
    # where the doubling reads them (p's inputs); the rest are free again
    dbl = _alloc(dd, _phases(dd, dbl_out), dbl_slots, set(dbl_out), fixed)

    phases = tuple(pre + gen + dbl)
    n_pre, n_gen = len(pre), len(gen)
    slots = 1 + max([one, zero] + [s for _m, ops in phases for op in ops for s in op[1:]])
    inf = (one,) + (zero,) * (C - 1)
    out = {
        "gen": tuple(gen_slots[v] for v in gen_out),
        "dbl": tuple(dbl_slots[v] for v in dbl_out),
        "p": tuple(range(3 * C)),
        "q": tuple(range(3 * C, 6 * C)),
        "inf": inf + inf + (zero,) * C,
    }
    return Schedule(C, slots, one, zero, phases, (0, n_pre), (n_pre, n_pre + n_gen),
                    (n_pre + n_gen, len(phases)), out, h_slots, rr_slots)


ADD_TEAM_LEVELS = {sec: schedule(True).levels(sec) for sec in ("pre", "gen", "dbl")}


def check(s: Schedule) -> None:
    """ValueError unless every phase fits a team, writes distinct slots
    that none of its operands occupies, and reads only slots written
    before it (inputs and constants at the start of each branch)."""
    for name in ("pre", "gen", "dbl"):
        lo, hi = getattr(s, name)
        written = set(range((3 if name == "dbl" else 6) * s.comps)) | {s.one, s.zero}
        if name == "gen":
            for _m, ops in s.phases[slice(*s.pre)]:
                written |= {op[1] for op in ops}
        for is_mul, ops in s.phases[lo:hi]:
            dsts = [op[1] for op in ops]
            reads = {x for op in ops for x in op[2:]}
            if len(ops) > TEAM or len(set(dsts)) != len(dsts) or reads & set(dsts):
                raise ValueError(f"phase of {name} breaks the team protocol: {ops}")
            if any((op[0] == MUL) != is_mul for op in ops) or not reads <= written:
                raise ValueError(f"phase of {name} reads an unwritten slot or mixes kinds: {ops}")
            written |= set(dsts)


# ---------------------------------------------------------------------------
# The plain executor
# ---------------------------------------------------------------------------


def add_team_plain(g2: bool, p, q, sched: Schedule | None = None):
    """The complete add by executing `sched` (default ``schedule(g2)``)
    phase by phase on ``hopper_field``'s plain Fq arithmetic: the same
    limbs as ``add_plain``.  Coordinates (n, L) or (n, 2, L) int32."""
    from . import hopper_field as hf

    s = sched or schedule(g2)
    f = hf.HALF["fq"]
    C = s.comps

    def comps(c):
        return [hf._half(c[:, k]) for k in range(C)] if g2 else [hf._half(c)]

    start: list = [None] * s.slots
    for k, t in enumerate(x for c in (*p, *q) for x in comps(c)):
        start[k] = t
    start[s.one] = f.one_like(start[0])
    start[s.zero] = torch.zeros_like(start[0])
    fn = {MUL: f.mul, ADD: f.add, SUB: f.sub}

    def run(slots, rng):
        slots = list(slots)
        for _m, ops in s.phases[slice(*rng)]:
            res = [(dst, fn[kind](slots[a], slots[b])) for kind, dst, a, b in ops]
            for dst, v in res:
                slots[dst] = v
        return slots

    pre = run(start, s.pre)
    res = {"gen": run(pre, s.gen), "dbl": run(pre, s.dbl), "p": start, "q": start, "inf": start}

    def coords(outcome):
        sl = [res[outcome][k] for k in s.out[outcome]]
        return [torch.stack(sl[c * C : (c + 1) * C], dim=-2) if g2 else sl[c] for c in range(3)]

    def zero(state, slots):
        return (torch.stack([state[k] for k in slots], dim=-2) == 0).flatten(-2).all(dim=-1)

    p_inf, q_inf = zero(start, range(2 * C, 3 * C)), zero(start, range(5 * C, 6 * C))
    h0, r0 = zero(pre, s.h), zero(pre, s.rr)
    # the first matching outcome wins, as the kernel's branch order
    pick = [(p_inf, "q"), (q_inf, "p"), (h0 & r0, "dbl"), (h0, "inf")]
    out = coords("gen")
    for cond, name in reversed(pick):
        alt = coords(name)
        sel = cond.reshape((-1,) + (1,) * (out[0].dim() - 1))
        out = [torch.where(sel, a, o) for a, o in zip(alt, out)]
    return tuple(hf._pack(c) for c in out)


# ---------------------------------------------------------------------------
# The kernel's table
# ---------------------------------------------------------------------------


def _rows(vals, per: int = 8, fmt: str = "{}") -> str:
    items = [fmt.format(v) for v in vals]
    return "\n".join("    " + ", ".join(items[i : i + per]) + "," for i in range(0, len(items), per))


def table(s: Schedule | None = None) -> list[int]:
    """The kernel's table as 32-bit words: one row of TEAM op words a phase
    (kind << 24 | dst << 16 | a << 8 | b; kind 0 a * b, 1 a + b, 2 a - b;
    NO_OP where the thread idles), then the 3C result slots of each outcome
    of OUTCOMES, then the slots of h and of rr; zero-padded to whole
    16-byte words."""
    s = s or schedule(True)
    words = []
    for _m, phase in s.phases:
        words += [(k << 24) | (d << 16) | (a << 8) | b for k, d, a, b in phase]
        words += [NO_OP] * (TEAM - len(phase))
    for o in OUTCOMES:
        words += list(s.out[o])
    words += list(s.h) + list(s.rr)
    return words + [0] * (-len(words) % 4)


def render_header(s: Schedule | None = None) -> str:
    """``csrc/add_team_g2.cuh``: the G2 schedule as the kernel reads it."""
    s = s or schedule(True)
    words = table(s)
    out_base = TEAM * len(s.phases)
    hr_base = out_base + 3 * s.comps * len(OUTCOMES)
    return f"""// GENERATED by `python -m vote_saver_tpu_torch.ops.add_team` from
// ops/add_team.schedule(g2=True); tests/test_torch_add_team.py holds this file
// equal to what that writes.  Do not edit by hand.
//
// The team schedule of the G2 complete add (add_team.cu): {len(s.phases)} phases over
// {s.slots} slots of one Fq value each.  Slots 0-{3 * s.comps - 1} hold p (x, y, z; c0, c1),
// {3 * s.comps}-{6 * s.comps - 1} q, {s.one} Montgomery one, {s.zero} zero.  Fq products of each
// multiply level: pre {s.levels("pre")}, gen {s.levels("gen")}, dbl {s.levels("dbl")}.
#pragma once

#include <cstdint>

// Row k < kPhases: the op word of each of the team's 16 threads in phase k,
// kind << 24 | dst << 16 | a << 8 | b (kind 0 a * b, 1 a + b, 2 a - b),
// 0xffffffff where the thread idles.  Then the result slots (x, y, z; c0,
// c1) of each outcome, in the order of AddTeamG2's enum, then the slots of
// h and of rr after the pre section.
__device__ uint32_t kAddTeamG2Table[{len(words)}] = {{
{_rows(words, 8, "0x{:08x}u")}
}};

struct AddTeamG2 {{
  static constexpr int kComps = {s.comps};
  static constexpr int kSlots = {s.slots};
  static constexpr int kOne = {s.one};
  static constexpr int kZero = {s.zero};
  static constexpr int kWords = {len(words)};
  // [begin, end) phases of each section
  static constexpr int kPreBegin = {s.pre[0]}, kPreEnd = {s.pre[1]};
  static constexpr int kGenBegin = {s.gen[0]}, kGenEnd = {s.gen[1]};
  static constexpr int kDblBegin = {s.dbl[0]}, kDblEnd = {s.dbl[1]};
  static constexpr int kOutBase = {out_base}, kHBase = {hr_base}, kRBase = {hr_base + s.comps};
  enum {{ kOutGen = 0, kOutDbl = 1, kOutP = 2, kOutQ = 3, kOutInf = 4 }};
  __device__ static __forceinline__ const uint32_t* table() {{ return kAddTeamG2Table; }}
}};
"""


if __name__ == "__main__":
    check(schedule(True))
    HEADER.write_text(render_header())
    print(f"wrote {HEADER}")
