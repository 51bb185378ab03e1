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
  * chip_smoke.py's ``[slice]`` (``run_slice``: the depth-6 B = 16 vote
    phase, its stage seconds, the host-witness and radix-2 batches and the
    profiled batch's device time per kernel).

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


def _per_call(fn, reps: int):
    """(device ms a call over every kernel fn launches, None where the
    profiler recorded no kernel; {kernel: device ms a call}; event-timed ms
    a call) over `reps` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].split("::")[-1][:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return (sum(by.values()) if by else None), by, ms


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f} ms"


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
    res = dict(tree=str(tree), gpu=micro.gpu_line(), g2_add={}, mont_mul_fr={})
    rnd = random.Random(cs.SEED + 10)
    for lanes in widths:
        p, q, *_ = special_lanes(True, max(lanes, 64), rnd)
        P, Qd = (tuple(lb.ints_to_tensor([pt[i] for pt in pts[:lanes]], lb.FQ, dev) for i in range(3))
                 for pts in (p, q))
        dev_ms, by, ms = _per_call(lambda P=P, Qd=Qd: hf.g2_add(P, Qd), 50 if lanes <= 1024 else 20)
        res["g2_add"][lanes] = dict(device_ms=dev_ms, kernels=by, ms=ms)
        print(f"[ab] g2_add {lanes} lanes: device {_ms(dev_ms)} a launch {by}, {ms:.4f} ms a call", flush=True)

    e = cs.election(cs.DEPTH)
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
        dev_ms, by, ms = _per_call(lambda a=a, b=b: hf.mont_mul("fr", a, b), 50)
        res["mont_mul_fr"][desc] = dict(device_ms=dev_ms, kernels=by, ms=ms)
        print(f"[ab] mont_mul_fr {desc}: device {_ms(dev_ms)} a call {by}, {ms:.4f} ms a call", flush=True)

    vote = cs.run_slice(random.Random(cs.SEED), e, set())
    keep = ("batch_s", "proofs_per_s", "stages_s", "host_arm_batch_s", "radix2_batch_s", "peak_bytes")
    res["slice"] = {k: vote[k] for k in keep}
    prof = vote.get("profile") or {}
    res["slice"]["profile"] = {k: prof.get(k) for k in ("wall_s", "busy_s", "plain_s", "port", "top_plain")}
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
        t = side.setdefault(r["tree"], dict(batch_s=[], g2_add={}, mont_mul_fr={}))
        t["batch_s"].append(r["slice"]["batch_s"])
        for k, v in r["g2_add"].items():
            t["g2_add"].setdefault(k, []).append(v["device_ms"])
        for k, v in r["mont_mul_fr"].items():
            t["mont_mul_fr"].setdefault(k, []).append(v["device_ms"])
    print(json.dumps({"ab": side, "gpu": runs[0]["gpu"]}), flush=True)


if __name__ == "__main__":
    main()
