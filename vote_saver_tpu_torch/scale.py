"""A whole election at one of the BASELINE configs, end to end, with its
timing record: voter keys, admin keys (Groth16 setup on the device), the
election data (the Merkle tree on the device), the parse, batched proving
(sequential batches, or the pipelined stream), a verified sample of the
ballots, the tally and its check.

Counterpart of ``scripts/scale_run.py`` over the port's phases.  The
phases run in that script's order and draw from one ``FrRandom(seed)`` in
its order, so a fresh run's blobs equal the JAX package's byte for byte
under the same seed.  ``--points P``, the counterpart of its
``--mesh-cpu``, runs the election on the P ranks of a points x 1 mesh
(``parallel.sharded.spawn``: gloo where they share the card), each calling
``run(..., mesh=)``: every rank computes the same keys and data, the five
MSMs of each batch are point-sharded, and rank 0 alone writes the caches
and the record, which gains ``"mesh"``, and verifies and tallies.  The
voters axis stays 1: the prover shards over points only, so a second
points group would run the same election again on the same card.  The
sequential batches only: the stream takes no mesh, as in that script.
The voter keys, the admin keys and the election data are cached under
``.torch_cache/scale_d{depth}_v{voters}/`` and a run resumes from them, as
the script's ``.bench_cache/`` does; a resumed run skips those steps'
draws, so its ballots are another seed's.  Which steps resume is read once
at the start, by rank 0 for every rank: a rank that read the markers
itself could find one that rank 0 wrote in this run, skip that step's
draws and prove another witness.

    python -m vote_saver_tpu_torch.scale --config 3 --stream --out SCALE_torch_cfg3.json
    python -m vote_saver_tpu_torch.scale --config 1 --device cpu
    python -m vote_saver_tpu_torch.scale --config 2 --points 2

Any failed ballot, tally check or count raises, and the command exits
non-zero.  The default device is the card; without one the run raises
before any work.  On ``device="cpu"`` the kernels' plain versions run,
but setup takes its host-native arm (the same keys): the plain window sums
take hours at depth 2 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import struct
import time

import torch
import torch.distributed as dist

from . import micro
from .ops import hopper_field as hf
from .ops import limbs as lb
from .params import MSG_SIZE
from .protocol import groth16, phases
from .utils.rng import FrRandom

CONFIGS = {
    1: dict(depth=2, voters=4, batch=4),
    2: dict(depth=6, voters=64, batch=16),
    3: dict(depth=10, voters=1024, batch=32),
    4: dict(depth=14, voters=10240, batch=32),
}
EID_BITS = 64
SEED = 0x5CA1E
CACHED = ("voter_init", "admin_keygen", "admin_data")
CACHE = pathlib.Path(__file__).resolve().parents[1] / ".torch_cache"


def log(msg: str) -> None:
    print(f"[scale] {msg}", flush=True)


def _sample(n_voters: int, verify_sample) -> list[int]:
    """The ballots to verify: ``verify_sample`` of them spread as the JAX
    script spreads them, or the voter indices it lists."""
    if isinstance(verify_sample, int):
        return list(range(0, n_voters, max(1, n_voters // verify_sample)))[:verify_sample]
    return list(verify_sample)


def run(config: int, voters: int | None = None, batch: int | None = None, stream: bool = False,
        verify_sample=4, device="cuda", seed: int = SEED, out=None, mesh=None) -> dict:
    """Run BASELINE config `config` (its voter count and batch overridden
    by `voters` / `batch`) on `device` and return the record; write it as
    JSON to `out` when given.  `verify_sample` is a count or a list of
    voter indices.  With a `mesh` every rank calls this alike; only rank 0
    writes, and only its record goes past the vote."""
    if mesh is not None and stream:
        raise ValueError("the stream runs unsharded: pass stream or mesh, not both")
    writer = mesh is None or dist.get_rank() == 0
    dev = lb.device_of(device)
    cfg = CONFIGS[config]
    depth = cfg["depth"]
    n_voters = voters or cfg["voters"]
    B = batch or cfg["batch"]
    on_card = dev.type == "cuda"
    rec = dict(config=config, depth=depth, voters=n_voters, batch=B,
               device=micro.gpu_line() if on_card else "cpu", times_s={})
    if mesh is not None:
        rec["mesh"] = " x ".join(f"{name}={size}" for name, size in zip(mesh.mesh_dim_names, mesh.shape))
    t = rec["times_s"]
    cache = CACHE / f"scale_d{depth}_v{n_voters}"
    cache.mkdir(parents=True, exist_ok=True)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def step(name, fn):
        t0 = time.perf_counter()
        res = fn()
        if on_card:
            torch.cuda.synchronize(dev)
        t[name] = time.perf_counter() - t0
        log(f"{name}: {t[name]:.3f} s")
        return res

    # which cached steps resume, fixed before any rank writes a marker
    resume = [{name: (cache / f"{name}.ok").exists() for name in CACHED}]
    if mesh is not None:
        dist.broadcast_object_list(resume, src=0)
    resume = resume[0]

    def cached(name, fn):
        """A tuple of blobs, kept on disk so that an interrupted run resumes."""
        marker = cache / f"{name}.ok"
        if resume[name]:
            t[name] = json.loads((cache / f"{name}.time").read_text())
            log(f"{name}: resumed from {cache}")
            return tuple((cache / f"{name}.{i}").read_bytes() for i in range(int(marker.read_text())))
        blobs = step(name, fn)
        if not writer:
            return blobs
        for i, b in enumerate(blobs):
            (cache / f"{name}.{i}").write_bytes(b)
        (cache / f"{name}.time").write_text(json.dumps(t[name]))
        marker.write_text(str(len(blobs)))
        return blobs

    rng = FrRandom(seed)
    flat = cached("voter_init", lambda: tuple(b for i in range(n_voters) for b in phases.init_voter_phase(i, rng)))
    keys = [(flat[2 * i], flat[2 * i + 1]) for i in range(n_voters)]
    pk_crs, vk_crs, pk_eid, sk_eid, vk_eid = cached("admin_keygen", lambda: phases.init_admin_phase_generate_keys(
        depth, EID_BITS, rng, device=dev if on_card else "host"))
    eid_b, rt_b, tree_b = cached(
        "admin_data",
        lambda: phases.init_admin_phase_generate_data(depth, EID_BITS, [k[0] for k in keys], rng, device=dev))
    ctx = step("vote_ctx_parse", lambda: phases.prepare_vote_context(
        depth, EID_BITS, tree_b, rt_b, eid_b, pk_eid, pk_crs, vk_crs, device=dev))
    rec["domain"] = ctx.pk.domain

    votes = [i % MSG_SIZE for i in range(n_voters)]
    batches = [(idx, [votes[i] for i in idx], [keys[i][1] for i in idx])
               for idx in (list(range(off, min(off + B, n_voters))) for off in range(0, n_voters, B))]
    timer = groth16.StageTimer(dev)
    before = dict(hf.launches)
    ballots = []
    first = None
    t0 = bt0 = time.perf_counter()
    if stream:
        outs = phases.vote_with_context_stream(ctx, batches, rng, timer=timer)
    else:
        outs = (phases.vote_with_context(ctx, *b, rng, timer=timer, mesh=mesh) for b in batches)
    for got in outs:
        ballots += got
        now = time.perf_counter()
        if first is None:
            first = now - t0  # includes the first use of every device constant and plan
        log(f"voted {len(ballots)}/{n_voters} ({now - bt0:.3f} s since the last batch)")
        bt0 = now
    t["vote_total"] = time.perf_counter() - t0
    t["vote_first_batch_incl_compile"] = first
    rec["vote_mode"] = "stream" if stream else "sequential"
    rec["proofs_per_s"] = n_voters / t["vote_total"]
    steady = t["vote_total"] - first
    rec["proofs_per_s_steady"] = (n_voters - B) / steady if n_voters > B and steady > 0 else None
    rec["stage_s"] = {k: v / len(batches) for k, v in timer.seconds.items()}
    rec["vote_launches"] = {k: v - before[k] for k, v in hf.launches.items() if v > before[k]}
    if not writer:
        return rec

    sample = _sample(n_voters, verify_sample)
    ok = step("vergrth16_sample", lambda: [
        phases.verify_ballot(ballots[i][0], ballots[i][1], ballots[i][2], vk_eid, vk_crs) for i in sample])
    rec["verified"] = sample
    if not all(ok):
        raise RuntimeError(f"ballot verification failed for voters {[i for i, v in zip(sample, ok) if not v]}")
    cts = [b[2] for b in ballots]
    dec_proof, voting_res = step(
        "tally_admin", lambda: phases.tally_admin_phase(depth, cts, sk_eid, vk_eid, pk_crs, vk_crs))
    if not step("tally_verify", lambda: phases.tally_voter_phase(
            depth, cts, vk_eid, pk_crs, vk_crs, voting_res, dec_proof)):
        raise RuntimeError("tally verification failed")
    n = struct.unpack(">Q", voting_res[:8])[0]
    counts = [int.from_bytes(voting_res[8 + 32 * i : 8 + 32 * (i + 1)], "big") for i in range(n)]
    expect = [votes.count(c) for c in range(MSG_SIZE)]
    if counts != expect:
        raise RuntimeError(f"tally mismatch: {counts} != {expect}")
    rec["tally_counts_ok"] = True
    rec["total_s"] = sum(v for k, v in t.items() if k != "vote_first_batch_incl_compile")
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else None
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=3, choices=sorted(CONFIGS))
    ap.add_argument("--voters", type=int, help="override the config's voter count")
    ap.add_argument("--batch", type=int, help="override the config's batch size")
    ap.add_argument("--stream", action="store_true", help="pipelined vote batches (vote_with_context_stream)")
    ap.add_argument("--verify-sample", type=int, default=4, help="how many ballots to verify one by one")
    ap.add_argument("--device", default="cuda", help='"cuda" (the default) or "cpu" (the plain versions)')
    ap.add_argument("--out", help="write the record there as JSON too")
    ap.add_argument("--points", type=int, help="run on the ranks of a points x 1 mesh, its points axis this size")
    args = ap.parse_args(argv)
    kw = dict(config=args.config, voters=args.voters, batch=args.batch, stream=args.stream,
              verify_sample=args.verify_sample, device=args.device, out=args.out)
    if args.points:
        from .parallel import sharded

        ranks = sharded.spawn(_rank, (kw,), args.points, 1, args.device, timeout=24 * 3600)
        rec = dict(ranks[0].value, rank_seconds=[r.seconds for r in ranks])
    else:
        rec = run(**kw)
    print(json.dumps(rec), flush=True)


def _rank(mesh, kw: dict) -> dict:
    return run(**kw, mesh=mesh)


if __name__ == "__main__":
    main()
