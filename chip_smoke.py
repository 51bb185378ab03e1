#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``vote_saver_tpu_torch``).

Phases, in order; any failure exits non-zero, and there is no CPU fallback:

  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build the four CUDA kernels from ``vote_saver_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card at the
     main path's widths (K1 at 2^16 lanes in Fq and Fr, K2-K4 at 2^14 lanes
     in G1 and G2), special lanes included; exact equality; both timed;
  4. a 2^16-point G1 MSM with uniform scalars at w = 10 against the native
     host MSM;
  5. depth-2 ballots for voters [0, 1, 2] of the committed election, byte
     for byte against ``tests/golden/torch_slice_d2.json``;
  6. the vote phase at depth 6 with B = 16 voters (setup cached under
     ``.torch_cache/``): one warm-up and two timed batches, every ballot
     verified, per-stage seconds, proofs/s and each kernel's launch count
     over the timed batches (a kernel of the path launched 0 times fails).

The last two lines of stdout are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Needs one CUDA device:

    python3 chip_smoke.py
"""

from __future__ import annotations

import importlib.abc
import json
import pathlib
import pickle
import random
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0xC41B5
DEPTH, BATCH, EID_BITS = 6, 16, 64
K1_LANES, CURVE_LANES = 1 << 16, 1 << 14
MSM_N, MSM_W = 1 << 16, 10
SOURCE = "vote_saver_tpu_torch/csrc/kernels.cu"


class _NoJax(importlib.abc.MetaPathFinder):
    """The port runs without JAX: importing it here is an error."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} imported on the port's path")
        return None


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _to_dev(cols, dev):
    from vote_saver_tpu_torch.ops import limbs as lb

    return tuple(lb.ints_to_tensor(list(c), lb.FQ, dev) for c in cols)


def _diff(a, b) -> int:
    import torch

    return max(
        int(((x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        for x, y in zip(a, b)
    )


def check_kernels(rnd) -> dict:
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.testing import MADD_EXC, special_lanes

    dev = torch.device("cuda")
    results = {}
    for name, spec in (("fq", lb.FQ), ("fr", lb.FR)):
        N = spec.modulus
        xs = [0, 1, N - 1, N - 1] + [rnd.randrange(N) for _ in range(K1_LANES - 4)]
        ys = [N - 1, 1, N - 1, 0] + [rnd.randrange(N) for _ in range(K1_LANES - 4)]
        a, b = lb.ints_to_tensor(xs, spec, dev), lb.ints_to_tensor(ys, spec, dev)
        got = hf.mont_mul(name, a, b)
        exp = hf.mont_mul_plain(name, a, b)
        torch.cuda.synchronize()
        sample = list(lb.tensor_to_ints(got[:64], spec))
        if sample != [x * y % N for x, y in zip(xs[:64], ys[:64])]:
            fail(f"mont_mul_{name} disagrees with Python integers")
        results[f"mont_mul_{name}"] = dict(
            equal=torch.equal(got, exp), max_abs_err=_diff((got,), (exp,)),
            ms=time_ms(lambda: hf.mont_mul(name, a, b), 50),
            plain_ms=time_ms(lambda: hf.mont_mul_plain(name, a, b), 3),
            lanes=K1_LANES,
        )
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        p, q, acc, qa, sign, active = special_lanes(g2, CURVE_LANES, rnd)
        P, Qd = _to_dev(zip(*p), dev), _to_dev(zip(*q), dev)
        A, QA = _to_dev(zip(*acc), dev), _to_dev(zip(*qa), dev)
        S = torch.tensor(sign, device=dev)
        ACT = torch.tensor(active, device=dev)
        madd = hf.g2_madd if g2 else hf.g1_madd
        add = hf.g2_add if g2 else hf.g1_add
        dbl = hf.g2_double if g2 else hf.g1_double
        cases = {
            f"{pre}_madd": (lambda: madd(A, QA, S, ACT), lambda: hf.madd_plain(g2, A, QA, S, ACT)),
            f"{pre}_add": (lambda: add(P, Qd), lambda: hf.add_plain(g2, P, Qd)),
            f"{pre}_double": (lambda: dbl(P), lambda: hf.double_plain(g2, P)),
        }
        for kname, (kern, plain) in cases.items():
            got, exp = kern(), plain()
            if kname.endswith("madd"):
                got, exp = (*got[0], got[1]), (*exp[0], exp[1])
                flags = got[-1][: len(MADD_EXC)].tolist()
                if flags != MADD_EXC:
                    fail(f"{kname} exc flags on the special lanes: {flags}")
            torch.cuda.synchronize()
            results[kname] = dict(
                equal=all(torch.equal(x, y) for x, y in zip(got, exp)),
                max_abs_err=_diff(got, exp),
                ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3), lanes=CURVE_LANES,
            )
    for kname, r in results.items():
        log(f"[kernels] {kname}: lanes={r['lanes']} equal={r['equal']} max_abs_err={r['max_abs_err']} "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms")
        if not r["equal"]:
            fail(f"{kname} kernel disagrees with its plain version")
    return results


# ---------------------------------------------------------------------------
# Phase 4: 2^16 G1 MSM against the native host MSM
# ---------------------------------------------------------------------------


def check_msm(rnd) -> dict:
    import torch

    from vote_saver_tpu import native_bridge as nb
    from vote_saver_tpu.params import R
    from vote_saver_tpu.refimpl import curves as rc
    from vote_saver_tpu.refimpl import jacobian as rj
    from vote_saver_tpu_torch.ops import curve_ops as co
    from vote_saver_tpu_torch.ops import msm_sched as ms

    pts = rj.FixedBaseHost(rc.g1_gen, "g1").mul_many([rnd.randrange(1, R) for _ in range(MSM_N)])
    scalars = [rnd.randrange(R) for _ in range(MSM_N)]
    t0 = time.perf_counter()
    sched = ms.build_schedule(scalars, MSM_W)
    sched_ms = (time.perf_counter() - t0) * 1e3
    pxy = ms.g1_affine_to_device(pts, "cuda")
    res, exc = ms.msm_device("g1", pxy, sched)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res, exc = ms.msm_device("g1", pxy, sched)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]
    got = co.g1_from_device(res)[0]
    if bool(exc) or got != nb.msm(pts, scalars):
        fail("2^16 G1 MSM does not match native_bridge.msm")
    out = dict(n=MSM_N, w=MSM_W, ms=dt * 1e3, mpoints_per_s=MSM_N / dt / 1e6, sched_host_ms=sched_ms,
               steps=int(sched.codes.shape[0]), lanes=int(sched.lanes))
    log(f"[msm] 2^16 G1 w=10: {out['ms']:.2f} ms = {out['mpoints_per_s']:.4f} Mpoints/s "
        f"(steps={out['steps']} lanes={out['lanes']} host schedule {sched_ms:.1f} ms); matches native")
    return out


# ---------------------------------------------------------------------------
# Phases 5-6: the vote phase
# ---------------------------------------------------------------------------


def check_golden() -> None:
    from vote_saver_tpu.utils.rng import FrRandom
    from vote_saver_tpu_torch.protocol import phases

    golden = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    e = pickle.loads((ROOT / golden["source"]).read_bytes())
    t0 = time.perf_counter()
    ctx = phases.prepare_vote_context(
        golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"], e["pk_eid"],
        e["pk_crs"], e["vk_crs"], device="cuda",
    )
    ballots = phases.vote_with_context(
        ctx, golden["voters"], golden["votes"], [e["voters"][i][1] for i in golden["voters"]],
        FrRandom(golden["seed"]),
    )
    for got, exp in zip(ballots, golden["ballots"]):
        if [x.hex() for x in got] != [exp[k] for k in ("proof", "pinput", "ct", "sn")]:
            fail("depth-2 ballots differ from tests/golden/torch_slice_d2.json")
    if len(ballots) != len(golden["ballots"]):
        fail("wrong number of depth-2 ballots")
    log(f"[golden] depth-2 ballots for voters {golden['voters']} byte-identical to the JAX golden "
        f"({time.perf_counter() - t0:.1f} s)")


def election(depth: int):
    """Voter keys, CRS, SAVER keys and election data for `depth` (blobs),
    cached under .torch_cache/ by depth and seed."""
    from vote_saver_tpu.utils.rng import FrRandom
    from vote_saver_tpu_torch.protocol import phases

    cache = ROOT / ".torch_cache" / f"election_d{depth}_s{SEED:x}.pkl"
    if cache.exists():
        log(f"[setup] depth {depth}: cached {cache.relative_to(ROOT)}")
        return pickle.loads(cache.read_bytes())
    t0 = time.perf_counter()
    rng = FrRandom(SEED)
    voters = [phases.init_voter_phase(i, rng) for i in range(BATCH)]
    keys = phases.init_admin_phase_generate_keys(depth, EID_BITS, rng)
    data = phases.init_admin_phase_generate_data(depth, EID_BITS, [v[0] for v in voters], rng)
    e = dict(voters=voters, keys=keys, data=data)
    cache.parent.mkdir(exist_ok=True)
    cache.write_bytes(pickle.dumps(e))
    log(f"[setup] depth {depth}: host-native setup {time.perf_counter() - t0:.1f} s")
    return e


def run_slice(rnd) -> dict:
    import torch

    from vote_saver_tpu.utils.rng import FrRandom
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import groth16, phases

    e = election(DEPTH)
    pk_crs, vk_crs, pk_eid, _sk_eid, vk_eid = e["keys"]
    eid, rt, tree = e["data"]
    t0 = time.perf_counter()
    ctx = phases.prepare_vote_context(DEPTH, EID_BITS, tree, rt, eid, pk_eid, pk_crs, vk_crs, device="cuda")
    log(f"[slice] context parsed in {time.perf_counter() - t0:.1f} s: {ctx.circ.cs.num_constraints} "
        f"constraints, {ctx.pk.num_vars} vars, domain {ctx.pk.domain}")
    idx = list(range(BATCH))
    sks = [v[1] for v in e["voters"]]
    rng = FrRandom(SEED + 1)

    def batch(timer=None):
        votes = [rnd.randrange(25) for _ in idx]
        return votes, phases.vote_with_context(ctx, idx, votes, sks, rng, timer=timer)

    t0 = time.perf_counter()
    warm = [batch()]
    torch.cuda.synchronize()
    log(f"[slice] warm-up batch (B={BATCH}): {time.perf_counter() - t0:.2f} s")
    hf.reset_launches()
    timer = groth16.StageTimer("cuda")
    t0 = time.perf_counter()
    timed = [batch(timer), batch(timer)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hf.launches)
    n_ok = 0
    for votes, ballots in warm + timed:
        for b in ballots:
            n_ok += phases.verify_ballot(b[0], b[1], b[2], vk_eid, vk_crs)
    n_total = BATCH * (len(warm) + len(timed))
    stages = {k: v / len(timed) for k, v in timer.seconds.items()}
    out = dict(
        depth=DEPTH, batch=BATCH, proofs_per_s=BATCH * len(timed) / wall,
        batch_s=wall / len(timed), stages_s=stages, fallbacks=timer.counts.get("fallbacks", 0),
        ballots_verified=n_ok, ballots_total=n_total, launches=launches,
    )
    log(f"[slice] depth {DEPTH}, B={BATCH}: {out['batch_s']:.3f} s/batch = {out['proofs_per_s']:.3f} proofs/s; "
        f"var-base fallbacks {out['fallbacks']}")
    log("[slice] per-batch stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log(f"[slice] launches over the two timed batches: {launches}")
    log(f"[slice] ballots verified: {n_ok}/{n_total}")
    if n_ok != n_total:
        fail("a depth-6 ballot failed verify_ballot")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels of the path never launched: {missing}")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    if not (ROOT / "vote_saver_tpu_torch").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, str(ROOT))
    t_all = time.perf_counter()
    gpu = gpu_line()
    log(gpu)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from vote_saver_tpu_torch.ops import _build
    from vote_saver_tpu_torch.ops import hopper_field as hf

    kl = _build.load()
    log(f"[build] {kl.path.name}: {kl.build_seconds:.1f} s")
    for line in kl.resource_usage.splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    rnd = random.Random(SEED)
    kern = check_kernels(rnd)
    check_msm(rnd)
    check_golden()
    launches = run_slice(rnd)["launches"]

    report = {"kernels": [
        dict(name=k, route="cuda", source=SOURCE, replaces=hf.REPLACES[k],
             launches=launches[k], max_abs_err=kern[k]["max_abs_err"],
             ms=kern[k]["ms"], plain_ms=kern[k]["plain_ms"])
        for k in hf.KERNELS
    ]}
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    log(gpu)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
