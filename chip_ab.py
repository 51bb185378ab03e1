#!/usr/bin/env python3
"""Checkouts of this repository against each other on one card, in turns.

    python3 chip_ab.py TREE [TREE ...] [--widths 16,32,256,16384] [--out DIR]

Each TREE is a checkout (the parent commit unpacked by ``git archive``,
this one as ``.``), run in a process of its own in the order given, the
usual order being parent, change, change, parent.  Each run builds the
TREE's kernels from its own sources and measures, with the TREE's own
code:

  * ``g2_add``, K3 in G2, on testing.special_lanes' points at each of
    ``--widths`` (the vote path's 16 and 32, its widest orphan merge, 2^14):
    device milliseconds a launch from torch.profiler, ms a call from CUDA
    events;
  * ``mont_mul`` in Fr at the depth-6 B = 16 batch's large calls with their
    real tables (the three COO products, the R1CS check, H times
    zh_coset_inv, the matmul NTT's twiddle), the operands passed as the
    vote path passes them: the device time of every kernel one call
    launches (a materialised broadcast's copy included) and of K1 alone;
  * the fold mode's bucket scans, suffix rounds and doublings in G1 and
    G2, each called with an explicit ``mode="fold"``: the scans at
    ``MSM_SHAPES``' path shapes (the h schedule's 80 rows x 248,832 lanes
    in G1, its first 32 rows in G2), the suffix rounds on their 432 x 512
    grids at shifts 1 and 256 (``FOLD_SHIFTS``), the G1 doubling at
    ``FOLD_DOUBLE`` (Horner's 16 lanes x 10, the ballot tail's 4 on 32 and
    480 lanes), the G2 doubling at ``FOLD_G2_DOUBLE`` (Horner's 16 x 10,
    the ballot tail's 32 x 4), the G1 complete add at ``FOLD_ADD`` (the
    vote path's 16, 32 and 480 lanes and 2^14, on generic lanes: no
    infinity, no doubling), the G2 complete add, the team add, at
    ``FOLD_G2_ADD`` (the vote path's 16 and 32 lanes, its widest orphan
    merge, 5,925, and 2^14, on generic lanes), the Fr inversion chain at
    ``FOLD_INV`` (the device witness's 16 lanes) and the Fq chain at
    ``FOLD_INV_FQ`` (the ballot tail's 464), on random elements:
    device ms a launch from torch.profiler, ms a call from CUDA events, the
    share of the function's bound (``chip_smoke.bound``: its multiply-adds
    at the Programming Guide's rate, the loop instance's bound) and of the
    fold algorithm's (``chip_smoke.mode_work``'s "fold"), each output equal
    to the loop instance's;
  * Groth16 setup's fixed-base products (``setup_window_sums``): the
    depth-6 admin key generation's wall seconds, and each group's
    ``groth16._fixed_base_batch`` on that setup's scalars alone under
    torch.profiler: launches and device ms by kernel;
  * chip_smoke.py's ``[slice]`` (``run_slice``: the depth-6 B = 16 vote
    phase, its stage seconds, the host-witness and radix-2 batches and the
    profiled batch's device time per kernel), its device-arm batches 0-2
    three times more (``loop_batches``), then ``[modes]``' fold batch
    (``fold_batch``: the batch under ``VSTPU_MUL=fold``, byte-identical to
    the loop batch, timed by stage, the G2 doubling's launch widths
    checked against ``FOLD_G2_DOUBLE``, and one profiled: busy share,
    device ms per kernel), then one more fold batch with its G1 suffix
    rounds counted (``suffix_doublings``: the warps that take the
    doubling of the complete add, and those that skip the add).

Every tree is profiled and bounded by this checkout's ``chip_smoke.py``
(``profile_window``, ``device_ms``, ``profile_batch``, ``bound``), loaded
beside the tree's own, so that the trees differ only in what they run.
Each run prints one JSON line (``[ab] {...}``) and writes it under
``--out`` (``.chip_scratch/ab/``); the last line sets the runs side by
side by tree.  The card's name and power limit lead each run's line.
Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

WIDTHS = (16, 32, 1 << 14)
# the fold doubling's (lanes, doublings) on the vote path: Horner's step, the ballot tail's
FOLD_DOUBLE = ((16, 10), (32, 4), (480, 4))
FOLD_G2_DOUBLE = ((16, 10), (32, 4))
# the fold G1 complete add's lanes (the vote path's launches are 16-480 wide) and the Fr chain's
FOLD_ADD, FOLD_INV = (16, 32, 480, 1 << 14), (16,)
# the fold G2 complete add's lanes (the vote path's: 16, 32 and orphan merges up to 5,925) and the Fq chain's
FOLD_G2_ADD, FOLD_INV_FQ = (16, 32, 5925, 1 << 14), (464,)
# the fold suffix round's shifts on the 432 x 512 grid: the first and the last round's
FOLD_SHIFTS = (1, 256)
WARP = 32  # a warp's lanes: the suffix round's kernel runs 32 consecutive lanes of its grid together


def _own():
    """This checkout's chip_smoke.py, loaded under a name of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_ab_smoke", pathlib.Path(__file__).resolve().with_name(
        "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _per_call(own, fn, reps: int):
    """(device ms a call over every kernel fn launches, None where the
    profiling window (profile_window) lost records or recorded no kernel;
    {kernel: device ms a call}; event-timed ms a call) over `reps` calls
    after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    _r, events = own.profile_window(fn, reps)
    by: dict = {}
    for name, us in events or ():
        name = name.split("(")[0].split("::")[-1][:60]
        by[name] = by.get(name, 0.0) + us / 1e3 / reps
    return (sum(by.values()) if by else None), by, ms


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f} ms"


def fold_kernels(cs, own, dev, reps: int = 5) -> dict:
    """The bucket scan, the suffix round, the doubling and the complete add
    of G1 and G2 and the Fr and Fq inversion chains with mode="fold" at the vote
    path's shapes (module docstring), each against
    the loop instance's output: {shape: device ms a launch
    (chip_smoke.device_ms), ms a call (CUDA events), the function's bound
    ms and share of it, the fold algorithm's bound ms and share of it}."""
    import random

    import torch

    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.testing import special_lanes

    rnd = random.Random(cs.SEED + 12)
    # the multiply-adds at the Programming Guide's rate (K9 raises it only where it measures more)
    rates = micro.card_int_rates({k: {"giter_s": 0.0} for k in micro.MUL_WIDE_KINDS})
    cases = []
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        table, codes, grid = cs._msm_inputs(g2, random.Random(cs.SEED + 13) if g2 else rnd, dev)
        codes = codes[: cs.MSM_SHAPES[f"{pre}_madd_scan"][0][0]].contiguous()
        live = codes != 0
        scan, shift_add = (hf.g2_madd_scan, hf.g2_add_shift) if g2 else (hf.g1_madd_scan, hf.g1_add_shift)
        cases.append((f"{pre}_madd_scan", f"{codes.shape[0]}x{codes.shape[1]}", "k_madd_scan",
                      lambda m, t=table, c=codes, scan=scan: scan(t, c, checked=True, mode=m), (*table, codes),
                      cs._curve_mads("madd", g2, int(live.sum()) - int(live.any(dim=0).sum())), "fq"))
        rows, bw = grid[0].shape[:2]
        fin = (grid[2] != 0).reshape(rows, bw, -1).any(dim=-1)
        for shift in FOLD_SHIFTS:
            pairs = int((fin[:, : bw - shift] & fin[:, shift:]).sum())
            cases.append((f"{pre}_add_shift", f"{rows}x{bw} shift {shift}", "k_add_shift",
                          lambda m, s=shift, gr=grid, f=shift_add: f(gr, s, mode=m), grid,
                          cs._curve_mads("add", g2, pairs), "fq"))
    for g2, shapes in ((False, FOLD_DOUBLE), (True, FOLD_G2_DOUBLE)):
        p, *_ = special_lanes(g2, max(n for n, _t in shapes), rnd)
        pts = cs._to_dev(zip(*p), dev)
        dbl = hf.g2_double if g2 else hf.g1_double
        for lanes, times in shapes:
            P = tuple(c[:lanes].contiguous() for c in pts)
            cases.append((f"{'g2' if g2 else 'g1'}_double", f"{lanes}x{times}", "k_double",
                          lambda m, P=P, t=times, dbl=dbl: dbl(P, t, mode=m), P,
                          times * cs._curve_mads("double", g2, lanes), "fq"))
    p, q, *_ = special_lanes(False, max(FOLD_ADD) + 8, rnd)
    pts, qts = (cs._to_dev(zip(*v[8:]), dev) for v in (p, q))
    for lanes in FOLD_ADD:
        P, Q = (tuple(c[:lanes].contiguous() for c in v) for v in (pts, qts))
        cases.append(("g1_add", str(lanes), "k_add<", lambda m, P=P, Q=Q: hf.g1_add(P, Q, mode=m), (*P, *Q),
                      cs._curve_mads("add", False, lanes), "fq"))
    p2, q2, *_ = special_lanes(True, 64 + 8, rnd)
    for lanes in FOLD_G2_ADD:
        P, Q = (cs._to_dev(zip(*[v[8 + i % 64] for i in range(lanes)]), dev) for v in (p2, q2))
        cases.append(("g2_add", str(lanes), "k_add_team", lambda m, P=P, Q=Q: hf.g2_add(P, Q, mode=m), (*P, *Q),
                      cs._curve_mads("add", True, lanes), "fq"))
    for name, widths in (("fr", FOLD_INV), ("fq", FOLD_INV_FQ)):
        spec = lb.spec_for(name)
        for lanes in widths:
            a = lb.ints_to_tensor([rnd.randrange(spec.modulus) for _ in range(lanes)], spec, dev)
            cases.append((f"mont_inv_{name}", str(lanes), "k_mont_inv<",
                          lambda m, a=a, name=name: (hf.mont_inv(name, a, m),), (a,),
                          lanes * cs.INV_MULS[name] * cs.MADS[name], name))
    out = {}
    for kname, shape, family, run, ins, mads, field in cases:
        got, want = run("fold"), run("loop")
        flat = lambda r: (*r[0], r[1]) if kname.endswith("scan") else r  # noqa: E731
        if not all(torch.equal(x, y) for x, y in zip(flat(got), flat(want))):
            raise SystemExit(f"{kname}_fold at {shape} differs from the loop instance")
        n = reps if family == "k_madd_scan" else 20
        ms = micro.time_ms(lambda run=run: run("fold"), n)
        dev_ms = own.device_ms(lambda run=run: run("fold"), n, family)
        work = own.mode_work(dict(bytes=own._nbytes(*ins, *flat(got)), mads=mads), "fold", field)
        bound_ms, bound_by = own.bound(work, rates)
        fold_ms, _by = own.bound(work["fold"], rates)
        share = None if dev_ms is None else bound_ms / dev_ms
        fold_share = None if dev_ms is None else fold_ms / dev_ms
        out[f"{kname}_fold {shape}"] = dict(device_ms=dev_ms, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                            share=share, fold_bound_ms=fold_ms, fold_share=fold_share)
        print(f"[ab] {kname}_fold {shape}: device {_ms(dev_ms)} a launch, {ms:.4f} ms a call, bound "
              f"{bound_ms:.5f} ms ({bound_by}), fold algorithm's bound {fold_ms:.5f} ms, " + (
                  "shares not measured" if share is None else
                  f"{100 * share:.2f}% / {100 * fold_share:.2f}% of them"), flush=True)
    return out


def setup_window_sums(cs, own) -> dict:
    """Groth16 setup's fixed-base products at depth 6, as both trees have
    them: the depth-6 admin key generation on the card (loop, after one
    warm-up call that builds the tables), its wall seconds, with
    ``groth16._fixed_base_batch`` wrapped to keep each group's scalars;
    then each group's ``_fixed_base_batch`` once more alone in a profiling
    window: its seconds, its launches by kernel (hopper_field's counts) and
    the device ms of every kernel it launched."""
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import groth16, phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    batch, scalars = groth16._fixed_base_batch, {}

    def kept(group, ks, device):
        scalars[group] = list(ks)
        return batch(group, ks, device)

    groth16._fixed_base_batch = kept
    try:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            phases.init_admin_phase_generate_keys(cs.DEPTH, cs.EID_BITS, FrRandom(cs.SEED), device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        groth16._fixed_base_batch = batch
    out = dict(wall_s=walls[1], first_wall_s=walls[0], groups={})
    for group, ks in scalars.items():
        hf.reset_launches()
        t0 = time.perf_counter()
        _r, events = own.profile_window(lambda ks=ks, group=group: batch(group, ks, "cuda"))
        call_s = time.perf_counter() - t0
        launches = {k: v for k, v in hf.launches.items() if v}
        by: dict = {}
        for name, us in events or ():  # the port's kernels by their kernels-line names
            name = own.kernel_key(name) or name.split("(")[0].split("::")[-1][:60]
            by[name] = by.get(name, 0.0) + us / 1e3
        out["groups"][group] = dict(n=len(ks), call_s=call_s, launches=launches, kernels=by,
                                    device_ms=sum(by.values()) if events is not None else None)
        print(f"[ab] setup {group}: {len(ks)} scalars, {call_s:.3f} s under the profiler, device "
              f"{_ms(out['groups'][group]['device_ms'])}, launches {launches}, by kernel {by}", flush=True)
    print(f"[ab] setup wall (depth {cs.DEPTH}, loop): {walls[1]:.3f} s (first call {walls[0]:.3f} s)", flush=True)
    return out


def loop_batches(cs, e: dict, vote: dict, cycles: int = 3) -> list:
    """More samples of the loop batch than [slice]'s mean of two: under
    VSTPU_MUL=loop (restored after), [slice]'s device-arm batches 0-2 again
    from FrRandom(SEED + 1) with their votes, `cycles` times over, each
    byte-identical to [slice]'s; the wall seconds of each batch."""
    import os

    import torch

    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    ctx, idx, sks = vote["ctx"], list(range(cs.BATCH)), [v[1] for v in e["voters"]]
    before = os.environ.get("VSTPU_MUL")
    os.environ["VSTPU_MUL"] = "loop"
    secs = []
    try:
        for _ in range(cycles):
            rng = FrRandom(cs.SEED + 1)
            for k, (votes, ballots) in enumerate(vote["device_batches"][:3]):
                t0 = time.perf_counter()
                got = phases.vote_with_context(ctx, idx, votes, sks, rng)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                if [[x.hex() for x in b] for b in got] != [[x.hex() for x in b] for b in ballots]:
                    raise SystemExit(f"loop batch {k} differs from [slice]'s ballots")
    finally:
        if before is None:
            os.environ.pop("VSTPU_MUL", None)
        else:
            os.environ["VSTPU_MUL"] = before
    print(f"[ab] loop batches: {', '.join(f'{v:.3f}' for v in secs)} s; byte-identical to [slice]'s", flush=True)
    return secs


def fold_batch(cs, own, e: dict, vote: dict) -> dict:
    """[modes]' fold batch with the tree's own code: under VSTPU_MUL=fold
    (restored after), [slice]'s device-arm batches 0-2 again from
    FrRandom(SEED + 1) with their votes, each byte-identical to [slice]'s:
    batch 1 timed by stage, its G2 doublings' launch widths (lanes:
    launches) held to FOLD_G2_DOUBLE's, batch 2 under torch.profiler (the
    device's busy share, device ms per kernel)."""
    import os

    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import groth16, phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    ctx, idx, sks = vote["ctx"], list(range(cs.BATCH)), [v[1] for v in e["voters"]]
    before = os.environ.get("VSTPU_MUL")
    os.environ["VSTPU_MUL"] = "fold"
    out: dict = {}
    try:
        rng = FrRandom(cs.SEED + 1)
        for k, (votes, loop_ballots) in enumerate(vote["device_batches"][:3]):
            if k == 2:
                got, prof = own.profile_batch(lambda v=votes: phases.vote_with_context(ctx, idx, v, sks, rng), set())
                out["profile"] = {key: prof.get(key) for key in ("wall_s", "busy_s", "plain_s", "port")}
            else:
                timer = groth16.StageTimer("cuda") if k == 1 else None
                hf.reset_launches()
                t0 = time.perf_counter()
                got = phases.vote_with_context(ctx, idx, votes, sks, rng, timer=timer)
                torch.cuda.synchronize()
                if k == 1:
                    out.update(batch_s=time.perf_counter() - t0, stages_s=dict(timer.seconds),
                               g2_double_widths=dict(hf.widths[hf.instance("g2_double", "fold")]))
                    if not set(out["g2_double_widths"]) <= {n for n, _t in FOLD_G2_DOUBLE}:
                        raise SystemExit(f"the fold batch's G2 doublings ran at {out['g2_double_widths']}, "
                                         f"not at FOLD_G2_DOUBLE's widths")
            if [[x.hex() for x in b] for b in got] != [[x.hex() for x in b] for b in loop_ballots]:
                raise SystemExit(f"fold batch {k} differs from the loop batch's ballots")
    finally:
        if before is None:
            os.environ.pop("VSTPU_MUL", None)
        else:
            os.environ["VSTPU_MUL"] = before
    prof = out.get("profile") or {}
    busy = "not measured" if not prof.get("busy_s") else f"busy {prof['busy_s']:.3f} s of {prof['wall_s']:.3f} s"
    print(f"[ab] fold batch: {out['batch_s']:.3f} s, {busy}; byte-identical to the loop batches; G2 doubling "
          f"widths {out['g2_double_widths']}", flush=True)
    return out


def suffix_doublings(cs, e: dict, vote: dict) -> dict:
    """The fold batch's G1 suffix rounds, counted by warp: under
    VSTPU_MUL=fold (restored after), [slice]'s device-arm batch 0 again
    (byte-identical to [slice]'s), with hopper_field.g1_add_shift wrapped
    so that each round also runs the flagged add g1_addx (loop instance) on
    the same operands, its partners from shift_partner.  A warp (32
    consecutive lanes of the round's flattened grid, as the kernel's) takes
    the complete add's doubling where the flag, equal finite operands, is
    set on any of its lanes, and skips the add where none of its lanes has
    a partner.  {rounds, warps, warps_doubling, warps_skipping}."""
    import os

    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    ctx, idx, sks = vote["ctx"], list(range(cs.BATCH)), [v[1] for v in e["voters"]]
    votes, ballots = vote["device_batches"][0]
    counts = dict(rounds=0, warps=0, warps_doubling=0, warps_skipping=0)
    add_shift = hf.g1_add_shift

    def counted(coords, shift, out=None, mode=None):
        rows, bw = coords[0].shape[:2]
        n = rows * bw
        inf = hf._infinity(False, (rows, bw), coords[0].device)
        _r, same = hf.g1_addx(coords, hf.shift_partner(coords, shift, inf), mode="loop")
        partner = torch.arange(n, device=same.device) % bw + shift < bw
        pad = -n % WARP
        by_warp = [torch.cat([v.reshape(-1), v.new_zeros(pad)]).reshape(-1, WARP).any(dim=1)
                   for v in (same != 0, partner)]
        counts["rounds"] += 1
        counts["warps"] += by_warp[0].numel()
        counts["warps_doubling"] += int((by_warp[0] & by_warp[1]).sum())
        counts["warps_skipping"] += int((~by_warp[1]).sum())
        return add_shift(coords, shift, out=out, mode=mode)

    before = os.environ.get("VSTPU_MUL")
    os.environ["VSTPU_MUL"] = "fold"
    hf.g1_add_shift = counted
    try:
        got = phases.vote_with_context(ctx, idx, votes, sks, FrRandom(cs.SEED + 1))
        torch.cuda.synchronize()
    finally:
        hf.g1_add_shift = add_shift
        if before is None:
            os.environ.pop("VSTPU_MUL", None)
        else:
            os.environ["VSTPU_MUL"] = before
    if [[x.hex() for x in b] for b in got] != [[x.hex() for x in b] for b in ballots]:
        raise SystemExit("the counted fold batch differs from [slice]'s ballots")
    print(f"[ab] fold batch G1 suffix rounds: {counts['rounds']} rounds, {counts['warps']} warps, "
          f"{counts['warps_doubling']} take the doubling, {counts['warps_skipping']} skip the add", flush=True)
    return counts


def one(tree: pathlib.Path, widths) -> dict:
    sys.path.insert(0, str(tree))
    import random

    import torch

    import chip_smoke as cs
    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.ops import ntt, ntt_mxu
    from vote_saver_tpu_torch.protocol import groth16, phases
    from vote_saver_tpu_torch.testing import special_lanes

    assert pathlib.Path(cs.__file__).resolve().parent == tree.resolve(), cs.__file__
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    own = _own()
    res = dict(tree=str(tree), gpu=micro.gpu_line(), g2_add={}, mont_mul_fr={})
    rnd = random.Random(cs.SEED + 10)
    for lanes in widths:
        p, q, *_ = special_lanes(True, max(lanes, 64), rnd)
        P, Qd = (tuple(lb.ints_to_tensor([pt[i] for pt in pts[:lanes]], lb.FQ, dev) for i in range(3))
                 for pts in (p, q))
        dev_ms, by, ms = _per_call(own, lambda P=P, Qd=Qd: hf.g2_add(P, Qd), 50 if lanes <= 1024 else 20)
        res["g2_add"][lanes] = dict(device_ms=dev_ms, kernels=by, ms=ms)
        print(f"[ab] g2_add {lanes} lanes: device {_ms(dev_ms)} a launch {by}, {ms:.4f} ms a call", flush=True)

    res["fold_kernels"] = fold_kernels(cs, own, dev)

    e = cs.election(cs.DEPTH)
    res["setup"] = setup_window_sums(cs, own)
    pk_crs, vk_crs, pk_eid, _sk_eid, _vk_eid = e["keys"]
    eid, rt, tree_blob = e["data"]
    ctx = phases.prepare_vote_context(cs.DEPTH, cs.EID_BITS, tree_blob, rt, eid, pk_eid, pk_crs, vk_crs,
                                      device="cuda")
    pk, B, n = ctx.pk, cs.BATCH, ctx.pk.domain
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)

    def limbs(*shape):
        k = 1
        for d in shape:
            k *= d
        return micro.random_limbs("fr", k, dev, gen).reshape(tuple(shape) + (lb.FR.num_limbs,))

    coo = groth16._abc_coo_device(pk, dev)
    w = limbs(B, pk.num_vars)
    x, y = limbs(B, n), limbs(B, n)
    plan = ntt_mxu.get_plan(n, "fwd")
    cases = [(f"coo_{m}", coo[m][2][None], w.index_select(1, coo[m][1])) for m in ("a", "b", "c")]
    cases += [("r1cs", x, y), ("h", x, ntt.get_ntt(n, "matmul").table("zh_coset_inv", dev)),
              ("twiddle", limbs(B, plan.n2, plan.n1), plan.table("t12", dev))]
    for desc, a, b in cases:
        dev_ms, by, ms = _per_call(own, lambda a=a, b=b: hf.mont_mul("fr", a, b), 50)
        res["mont_mul_fr"][desc] = dict(device_ms=dev_ms, kernels=by, ms=ms)
        print(f"[ab] mont_mul_fr {desc}: device {_ms(dev_ms)} a call {by}, {ms:.4f} ms a call", flush=True)

    vote = cs.run_slice(random.Random(cs.SEED), e, set())
    keep = ("batch_s", "proofs_per_s", "stages_s", "host_arm_batch_s", "radix2_batch_s", "peak_bytes")
    res["slice"] = {k: vote[k] for k in keep}
    prof = vote.get("profile") or {}
    res["slice"]["profile"] = {k: prof.get(k) for k in ("wall_s", "busy_s", "plain_s", "port", "top_plain")}
    res["loop_batches_s"] = loop_batches(cs, e, vote)
    res["fold_batch"] = fold_batch(cs, own, e, vote)
    res["suffix_doublings"] = suffix_doublings(cs, e, vote)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--out", default=".chip_scratch/ab", help="directory for each run's JSON line")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="0", help=argparse.SUPPRESS)
    args = ap.parse_args()
    widths = [int(v) for v in args.widths.split(",")]
    out = pathlib.Path(args.out).resolve()
    if args.one:
        res = one(pathlib.Path(args.one), widths)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"run{args.tag}.json").write_text(json.dumps(res))
        print("[ab] " + json.dumps(res), flush=True)
        return
    if not args.trees:
        ap.error("name at least one checkout")
    runs = []
    for i, tree in enumerate(args.trees):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--one", tree, "--widths",
                               args.widths, "--out", str(out), "--tag", str(i)], check=False)
        if proc.returncode != 0:
            raise SystemExit(f"run {i} ({tree}) failed: {proc.returncode}")
        runs.append(json.loads((out / f"run{i}.json").read_text()))
        print(f"[ab] run {i} ({tree}): {time.perf_counter() - t0:.1f} s", flush=True)
    side = {}
    for r in runs:
        t = side.setdefault(r["tree"], dict(batch_s=[], loop_batches_s=[], fold_batch_s=[], fold_busy_s=[], g2_add={},
                                            mont_mul_fr={}, fold_kernels={}, setup_wall_s=[], setup_device_ms={}))
        t["setup_wall_s"].append(r["setup"]["wall_s"])
        for group, v in r["setup"]["groups"].items():
            t["setup_device_ms"].setdefault(group, []).append(v["device_ms"])
        t["batch_s"].append(r["slice"]["batch_s"])
        t["loop_batches_s"] += r["loop_batches_s"]
        t["fold_batch_s"].append(r["fold_batch"]["batch_s"])
        t["fold_busy_s"].append((r["fold_batch"].get("profile") or {}).get("busy_s"))
        for k, v in r["fold_kernels"].items():
            t["fold_kernels"].setdefault(k, []).append((v["device_ms"], v["ms"]))
        for k, v in r["g2_add"].items():
            t["g2_add"].setdefault(k, []).append(v["device_ms"])
        for k, v in r["mont_mul_fr"].items():
            t["mont_mul_fr"].setdefault(k, []).append(v["device_ms"])
    print(json.dumps({"ab": side, "gpu": runs[0]["gpu"]}), flush=True)


if __name__ == "__main__":
    main()
