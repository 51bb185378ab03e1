"""The prover's forward step on one device, and the multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py``.  ``entry()``
returns the forward step of the Groth16 prover core on small fixed shapes
(the coset-NTT division of H, then one G1 MSM over it at n = 128) with its
inputs.  ``dryrun_multichip(n)`` starts n ranks of one (points, voters)
mesh (``parallel.sharded.spawn``) and runs, on each, the steps of the
JAX dry run in its mesh split (voters = 2 when n is even): the
voter-sharded NTT, the stage-parallel NTT4 at 2^8, the point-sharded MSM,
the point-sharded scheduled MSM and the voter-sharded tally, then, on the
card, one ``vote_with_context(mesh=)`` at depth 2.  Each result is held
against its unsharded counterpart here, and the first mismatch raises.

    python -m vote_saver_tpu_torch.entry --devices 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import random
import time

import numpy as np
import torch

from .ops import curve_ops as co
from .ops import limbs as lb
from .ops import msm
from .ops import msm_sched as ms
from .ops import ntt_mxu
from .ops.field_ops import fr_ops
from .ops.ntt import choose_path, get_ntt
from .params import R
from .parallel import sharded
from .refimpl import curves as rc
from .refimpl import jacobian as rj

ENTRY_N = 128
NTT_N, NTT4_N, NTT4_KIND = 16, 256, "fwd_coset"
SCHED_W, SCHED_BITS = 5, 40
# the depth-2 election of the dry run's vote, and its voters
VOTE_DEPTH, VOTE_EID_BITS, VOTE_VOTERS, VOTE_VOTES = 2, 64, [0, 1], [1, 2]


def entry(device="cuda"):
    """(forward_step, (a_ev, b_ev, c_ev)): forward_step(a, b, c) divides
    A*B - C by Z_H on the coset and returns one G1 MSM over H's
    coefficients, with 128 fixed points (multiples of the generator) and
    random evaluations from the JAX entry's seed, on `device`."""
    dev = lb.device_of(device)
    rng = random.Random(0xBE)
    n = ENTRY_N
    g1 = co.g1_ops()
    f = fr_ops()
    ntt = get_ntt(n, choose_path(None, n, dev))
    pts, p = [], rc.g1_gen
    for _ in range(n):
        pts.append(p)
        p = rc.g1_add(p, rc.g1_gen)
    points = co.g1_to_device(pts, dev)

    def forward_step(a_ev, b_ev, c_ev):
        ca = ntt.coset_ntt(ntt.intt(a_ev))
        cb = ntt.coset_ntt(ntt.intt(b_ev))
        cc = ntt.coset_ntt(ntt.intt(c_ev))
        h_ev = f.mul(f.sub(f.mul(ca, cb), cc), ntt.table("zh_coset_inv", a_ev.device))
        h = f.from_mont(ntt.coset_intt(h_ev))
        return msm.msm_var_base(g1, points, msm.limbs_to_window_digits(h))

    evs = tuple(lb.ints_to_tensor([rng.randrange(R) for _ in range(n)], lb.FR, dev) for _ in range(3))
    return forward_step, evs


def sharded_cases(rnd: random.Random, n_points: int, n_voters: int, scale: int = 1) -> dict:
    """The dry run's inputs for a (n_points, n_voters) mesh, in the JAX dry
    run's order of draws: B = 2 * n_voters polynomials of 2^4 for the
    voter-sharded NTT, one of 2^8 for NTT4, 4 * scale points a point shard
    for the MSM, 8 * scale with 40-bit scalars and a w = 5 schedule a shard
    for the scheduled MSM, 2 * scale ciphertexts of 3 slots a voter shard
    for the tally.  Plain ints and numpy, as the ranks take them."""
    B = 2 * n_voters
    cases = {"ntt": lb.ints_to_mont_limbs([[rnd.randrange(R) for _ in range(NTT_N)] for _ in range(B)], lb.FR),
             "ntt4": lb.ints_to_mont_limbs([rnd.randrange(R) for _ in range(NTT4_N)], lb.FR)}
    n = 4 * scale * n_points
    cases["msm"] = ([rc.g1_mul(rc.g1_gen, rnd.randrange(R)) for _ in range(n)], [rnd.randrange(R) for _ in range(n)])
    n = 8 * scale * n_points
    pts = [rc.g1_mul(rc.g1_gen, rnd.randrange(R)) for _ in range(n)]
    ks = [rnd.randrange(1 << SCHED_BITS) for _ in range(n)]
    s = n // n_points
    cases["msm_scheduled"] = (pts, ks, [ms.build_schedule(ks[i * s : (i + 1) * s], SCHED_W, scalar_bits=SCHED_BITS)
                                        for i in range(n_points)])
    n = 2 * scale * n_voters
    cases["tally"] = [[rc.g1_mul(rc.g1_gen, rnd.randrange(R)) for _ in range(3)] for _ in range(n)]
    return cases


def run_cases(mesh, cases: dict) -> dict:
    """Each sharded function on its case (``sharded_cases``) on this rank;
    the results as numpy limbs (Jacobian coords, Montgomery)."""
    dev = sharded.mesh_device(mesh)
    out = {"ntt": lb.from_tensor(sharded.sharded_ntt(mesh, get_ntt(NTT_N), lb.to_tensor(cases["ntt"], dev))),
           "ntt4": lb.from_tensor(sharded.sharded_ntt4(mesh, "points", ntt_mxu.get_plan(NTT4_N, NTT4_KIND),
                                                       lb.to_tensor(cases["ntt4"], dev)))}
    pts, ks = cases["msm"]
    res = sharded.sharded_msm(mesh, co.g1_to_device(pts, dev), msm.scalars_to_window_digits(ks))
    out["msm"] = tuple(lb.from_tensor(c) for c in res)
    pts, _ks, schedules = cases["msm_scheduled"]
    res, exc = sharded.sharded_msm_scheduled(mesh, "g1", ms.g1_affine_to_device(pts, dev), schedules)
    out["msm_scheduled"] = (tuple(lb.from_tensor(c) for c in res), int(exc))
    cts = cases["tally"]
    flat = co.g1_to_device([p for row in cts for p in row], dev)
    res = sharded.sharded_tally(mesh, tuple(c.reshape(len(cts), 3, *c.shape[1:]) for c in flat))
    out["tally"] = tuple(lb.from_tensor(c) for c in res)
    return out


def unsharded_cases(cases: dict, device) -> dict:
    """What run_cases must give, from the unsharded functions on `device`
    (the NTTs, as limbs) and the host oracle (the MSMs and the tally, as
    affine points)."""
    dev = lb.device_of(device)
    want = {"ntt": lb.from_tensor(get_ntt(NTT_N).intt(lb.to_tensor(cases["ntt"], dev))),
            "ntt4": lb.from_tensor(ntt_mxu.get_plan(NTT4_N, NTT4_KIND).apply(lb.to_tensor(cases["ntt4"], dev)))}
    want["msm"] = rj.msm_host(*cases["msm"])
    pts, ks, _s = cases["msm_scheduled"]
    want["msm_scheduled"] = rj.msm_host(pts, ks)
    sums = [None] * 3
    for row in cases["tally"]:
        sums = [rc.g1_add(a, p) for a, p in zip(sums, row)]
    want["tally"] = sums
    return want


def check_cases(got: dict, want: dict) -> list[str]:
    """Hold run_cases' results against unsharded_cases' (the MSMs and the
    tally as affine points); raises RuntimeError at the first mismatch,
    else returns the checks made."""
    coords, exc = got["msm_scheduled"]
    checks = (("NTT", np.array_equal(got["ntt"], want["ntt"])),
              ("NTT4", np.array_equal(got["ntt4"], want["ntt4"])),
              ("MSM", _affine(got["msm"])[0] == want["msm"]),
              ("scheduled MSM", exc == 0 and _affine(tuple(c[0] for c in coords))[0] == want["msm_scheduled"]),
              ("tally", _affine(got["tally"]) == want["tally"]))
    for name, ok in checks:
        if not ok:
            raise RuntimeError(f"sharded {name} differs from its unsharded result")
    return [name for name, _ok in checks]


def _affine(coords):
    return co.g1_from_device(tuple(lb.to_tensor(c) for c in coords))


def _election(device, seed: int):
    """A depth-2 election of two voters on `device`: its parsed context,
    the voters' secret keys and vk_eid, vk_crs."""
    from .protocol import phases
    from .utils.rng import FrRandom

    rng = FrRandom(seed)
    voters = [phases.init_voter_phase(i, rng) for i in VOTE_VOTERS]
    pk_crs, vk_crs, pk_eid, _sk_eid, vk_eid = phases.init_admin_phase_generate_keys(
        VOTE_DEPTH, VOTE_EID_BITS, rng, device)
    eid, rt, tree = phases.init_admin_phase_generate_data(VOTE_DEPTH, VOTE_EID_BITS, [v[0] for v in voters], rng,
                                                          device)
    ctx = phases.prepare_vote_context(VOTE_DEPTH, VOTE_EID_BITS, tree, rt, eid, pk_eid, pk_crs, vk_crs, device)
    return dict(ctx=ctx, sks=[v[1] for v in voters], vk_eid=vk_eid, vk_crs=vk_crs)


def vote(mesh, ctx, voters, votes, sks, seed: int):
    """``vote_with_context`` of one batch under ``FrRandom(seed)``: the
    ballots.  With a mesh, on this rank's device (``ctx.on``: ranks get
    the parsed context, not the blobs to parse again); without, on
    ``ctx.device``."""
    from .protocol import phases
    from .utils.rng import FrRandom

    if mesh is not None:
        ctx = ctx.on(sharded.mesh_device(mesh))
    return phases.vote_with_context(ctx, voters, votes, sks, FrRandom(seed), mesh=mesh)


def _rank(mesh, cases: dict, election: dict | None, seed: int) -> dict:
    out = {"cases": run_cases(mesh, cases), "transport": sharded.transport(mesh)}
    if election is not None:
        out["ballots"] = vote(mesh, election["ctx"], VOTE_VOTERS, VOTE_VOTES, election["sks"], seed)
    return out


def dryrun_multichip(n_devices: int, device_type: str = "cuda", backend: str | None = None, seed: int = 7) -> dict:
    """Run the dry run on n_devices ranks (``sharded.spawn``: gloo where
    they share a card or run on the CPU) and check every rank's results,
    the unsharded ones computed here while the ranks run.  The vote runs
    on the card only: on the CPU the plain scheduled MSMs of one depth-2
    batch take tens of minutes.  Returns what each rank did (seconds,
    kernel launches), the backend, the transport and the seconds of each
    step here."""
    t0 = time.perf_counter()
    n_voters = 2 if n_devices % 2 == 0 else 1
    n_points = n_devices // n_voters
    dev = lb.device_of(device_type)
    backend = backend or sharded.default_backend(dev.type, n_devices)
    cases = sharded_cases(random.Random(seed), n_points, n_voters)
    election = _election(dev, seed) if dev.type == "cuda" else None
    steps = {"inputs": time.perf_counter() - t0}
    sent = None if election is None else dict(election, ctx=election["ctx"].on(dev))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(sharded.spawn, _rank, (cases, sent, seed), n_points, n_voters, dev, backend)
        t1 = time.perf_counter()
        want = unsharded_cases(cases, dev)
        if election is not None:
            plain = vote(None, election["ctx"], VOTE_VOTERS, VOTE_VOTES, election["sks"], seed)
        steps["unsharded"] = time.perf_counter() - t1
        ranks = spawned.result()
    steps["ranks"] = time.perf_counter() - t1
    for i, r in enumerate(ranks):
        if r.foreign:
            raise RuntimeError(f"rank {i} imported {r.foreign}")
    checks = check_cases(ranks[0].value["cases"], want)
    if any(not _equal(r.value["cases"], ranks[0].value["cases"]) for r in ranks[1:]):
        raise RuntimeError("the ranks' results differ")
    if election is not None:
        from .protocol import phases

        if any(r.value["ballots"] != plain for r in ranks):
            raise RuntimeError("sharded ballots differ from the unsharded ones")
        if not all(phases.verify_ballot(b[0], b[1], b[2], election["vk_eid"], election["vk_crs"]) for b in plain):
            raise RuntimeError("a sharded ballot failed verify_ballot")
        checks.append(f"vote_with_context(mesh=) at depth {VOTE_DEPTH}, B = {len(VOTE_VOTERS)}")
    out = dict(n_points=n_points, n_voters=n_voters, backend=backend, transport=ranks[0].value["transport"],
               checks=checks, seconds=time.perf_counter() - t0, steps=steps,
               ranks=[dict(seconds=r.seconds, ready_s=r.ready_s, launches=r.launches) for r in ranks])
    print(f"dryrun_multichip({n_devices}): {', '.join(checks)} OK on points={n_points} x voters={n_voters}, "
          f"{backend} ({out['transport']} transport), {out['seconds']:.1f} s", flush=True)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4, help="ranks of the mesh")
    ap.add_argument("--device", default="cuda", help='"cuda" (the default; every rank on the card) or "cpu"')
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
