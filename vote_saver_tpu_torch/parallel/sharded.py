"""Sharded MSM / NTT / tally over a torch.distributed DeviceMesh.

Counterpart of ``vote_saver_tpu/parallel/sharded.py``.  JAX's ``Mesh`` is
one controller driving many devices; here every rank is a process of its
own, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("points", "voters")``.  Every sharded function runs on
every rank with the same replicated arguments, takes its own slice by its
coordinate on the axis (``mesh.get_local_rank(axis)``) and returns the
replicated result that the JAX function's ``out_specs=P()`` gives, so the
same call returns the same value as there (``sharded_ntt``'s voter-sharded
output comes back gathered whole).

Layout, as there:
  * `points`: the MSM's points and scalars are cut into D contiguous
    shards; each rank runs its local MSM, the D partial sums (one point a
    part) are all-gathered in rank order and tree-added with the complete
    add (``JacobianOps.sum_reduce``), JAX's tiled gather order;
  * `voters`: ballots and polynomials are data-parallel; the tally's
    per-rank aggregates are combined the same all-gather way.

Transport: NCCL moves CUDA tensors between cards; gloo, which the CPU and
several ranks sharing one card use, takes CUDA tensors too and moves them
through host memory (``transport``): an MSM's partials are one point a
part a rank, NTT4's exchange n * L / D words.  The backend is the caller's
choice (``make_mesh`` / ``spawn``), or the rule of ``default_backend``.

``spawn`` starts the ranks of one mesh as processes on this host (gloo on
the CPU or on one card, NCCL with a card a rank) and runs a function of
the port on each; the ranks import nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops import curve_ops as co
from ..ops import hopper_field as hf
from ..ops import limbs as lb
from ..ops import msm as msm_mod
from ..ops import msm_sched as ms

AXES = ("points", "voters")
# what a spawned rank must not have imported (RankResult.foreign)
FOREIGN = ("jax", "jaxlib", "vote_saver_tpu")


def default_backend(device_type: str, world_size: int) -> str:
    """gloo on the CPU and where ranks share a card, NCCL where every rank
    has a card of its own."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(backend: str | None = None) -> bool:
    """Join the process group the environment names: VSTPU_DISTRIBUTED=1
    with VSTPU_COORD=host:port, VSTPU_NPROC and VSTPU_PROCID, over
    `backend` (None: ``default_backend``).  No-op (False) when
    VSTPU_DISTRIBUTED is unset or the group already exists."""
    if not os.environ.get("VSTPU_DISTRIBUTED") or dist.is_initialized():
        return False
    world_size = int(os.environ["VSTPU_NPROC"])
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu", world_size)
    dist.init_process_group(backend, init_method=f"tcp://{os.environ['VSTPU_COORD']}", world_size=world_size,
                            rank=int(os.environ["VSTPU_PROCID"]))
    return True


def make_mesh(n_points: int, n_voters: int = 1, device_type: str = "cuda", backend: str | None = None) -> DeviceMesh:
    """A (points, voters) mesh over every rank of the process group, which
    ``init_distributed(backend)`` joins first if it does not exist yet."""
    init_distributed(backend)
    if not dist.is_initialized():
        raise RuntimeError("no process group: set VSTPU_DISTRIBUTED and VSTPU_COORD / NPROC / PROCID, "
                           "or start the ranks with spawn()")
    if dist.get_world_size() != n_points * n_voters:
        raise ValueError(f"a {n_points} x {n_voters} mesh needs {n_points * n_voters} ranks, "
                         f"not {dist.get_world_size()}")
    return init_device_mesh(device_type, (n_points, n_voters), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_rank(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(size of `axis`, this rank's coordinate on it)."""
    return mesh.shape[AXES.index(axis)], mesh.get_local_rank(axis)


def _shard(n: int, d: int, r: int) -> slice:
    if n % d:
        raise ValueError(f"{n} rows do not split into {d} shards")
    return slice(r * n // d, (r + 1) * n // d)


def transport(mesh: DeviceMesh, axis: str = "points") -> str:
    """"device" where the axis's collectives move tensors between cards
    (NCCL), "host" where they pass through the host (gloo, which takes
    CUDA tensors and stages them through host memory itself)."""
    return "device" if dist.get_backend(mesh.get_group(axis)) == "nccl" else "host"


def all_gather(mesh: DeviceMesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """(D, *t.shape): every rank's `t` on the axis, in rank order."""
    group = mesh.get_group(axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def all_to_all(mesh: DeviceMesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """t (D, ...): chunk j goes to the rank at coordinate j; chunk k of the
    result came from the rank at coordinate k."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.get_group(axis))
    return out


def all_reduce_sum(mesh: DeviceMesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def sharded_msm(mesh: DeviceMesh, points, scalar_digits):
    """MSM with the points and their digits sharded over `points`; returns
    the full Jacobian sum on every rank.

    points: G1 Jacobian coords (n, L); scalar_digits: (n, W) 4-bit windows
    (LSB first).  n must be divisible by the axis size."""
    g1 = co.g1_ops()
    d, r = axis_rank(mesh, "points")
    sl = _shard(points[0].shape[0], d, r)
    digits = torch.as_tensor(np.asarray(scalar_digits)[sl], device=points[0].device)
    part = msm_mod.msm_var_base(g1, tuple(c[sl] for c in points), digits)
    return g1.sum_reduce(tuple(all_gather(mesh, "points", c) for c in part), axis=0)


def sharded_tally(mesh: DeviceMesh, ct_points):
    """Homomorphic ciphertext aggregation across `voters`.

    ct_points: G1 Jacobian coords with leading dims (n_voters, n_slots).
    Returns the aggregate (n_slots,) ciphertext on every rank."""
    g1 = co.g1_ops()
    d, r = axis_rank(mesh, "voters")
    sl = _shard(ct_points[0].shape[0], d, r)
    part = g1.sum_reduce(tuple(c[sl] for c in ct_points), axis=0)
    return g1.sum_reduce(tuple(all_gather(mesh, "voters", c) for c in part), axis=0)


def pad_schedules(schedules):
    """Pad a list of per-shard msm_sched.Schedule objects to one common
    (steps, lanes) shape so their code/merge arrays stack."""
    steps = max(s.codes.shape[0] for s in schedules)
    lanes = max(s.lanes for s in schedules)
    canon = schedules[0].merge_gather.shape[0]
    codes, parts_, gathers = [], [], []
    for s in schedules:
        assert s.merge_gather.shape[0] == canon
        c = np.zeros((steps, lanes), dtype=np.int32)
        c[: s.codes.shape[0], : s.codes.shape[1]] = s.codes
        m = np.zeros((s.merge_part.shape[0], lanes - canon), dtype=np.int32)
        m[:, : s.merge_part.shape[1]] = s.merge_part
        codes.append(c)
        parts_.append(m)
        gathers.append(s.merge_gather)
    return np.stack(codes), np.stack(parts_), np.stack(gathers)


def sharded_msm_scheduled(mesh: DeviceMesh, group: str, points_xy, schedules):
    """The scheduled-bucket Pippenger MSM across ranks.

    Shard d owns points [d*n/D, (d+1)*n/D) and a conflict-free schedule
    built from its scalar slice; every rank runs the bucket and combination
    phases on its shard, then the D partials (one point a part) are
    all-gathered and tree-added.  The schedules are padded to one shape, as
    in the JAX package.

    points_xy: (x, y) affine limb tensors with leading dim n (= D * n_shard)
    from msm_sched.g{1,2}_affine_to_device; schedules: D msm_sched.Schedule
    with one window_bits / num_windows / num_parts.  Returns (Jacobian
    coords (parts, ...), the axis's count of exceptional lanes' flags)."""
    d, r = axis_rank(mesh, "points")
    if len(schedules) != d:
        raise ValueError(f"{len(schedules)} schedules for {d} point shards")
    s0 = schedules[0]
    codes, parts_, gathers = pad_schedules(schedules)
    fn = sharded_msm_scheduled_fn(mesh, group, s0.num_windows, s0.window_bits, s0.num_parts)
    sl = _shard(points_xy[0].shape[0], d, r)
    return fn(tuple(c[sl] for c in points_xy), codes[r], parts_[r], gathers[r])


def sharded_msm_scheduled_fn(mesh: DeviceMesh, group: str, K: int, w: int, parts: int):
    """The per-rank callable behind sharded_msm_scheduled, for callers in
    which each rank holds only its own shard: fn(points_xy of the shard,
    codes, merge_part, merge_gather of its schedule) -> (the summed coords
    (parts, ...), the flags' count over `points`, an int32 () tensor)."""
    ops = co.g1_ops() if group == "g1" else co.g2_ops()

    def local(pxy, codes, merge_part, merge_gather):
        codes = np.asarray(codes, np.int32)
        sched = ms.Schedule(codes, np.asarray(merge_part, np.int32), np.asarray(merge_gather, np.int32), w, K,
                            codes.shape[1], int(np.count_nonzero(codes)), parts)
        res, exc = ms.msm_device(group, pxy, sched)
        total = ops.sum_reduce(tuple(all_gather(mesh, "points", c) for c in res), axis=0)
        return total, all_reduce_sum(mesh, "points", exc.to(torch.int32))

    return local


def sharded_ntt4(mesh: DeviceMesh, axis: str, plan, x: torch.Tensor) -> torch.Tensor:
    """Stage-parallel single-polynomial NTT: the 4-step decomposition of
    ops.ntt_mxu with the middle transpose as one all-to-all over `axis`.

    Steps A and B (``plan.steps_ab``) run on the rank's n2/D columns, step
    C (``plan.step_c``) on its n1/D rows; the only traffic between ranks is
    the n1 <-> n2 transpose, and the gather of the result.

    x: (n, L) Montgomery limbs (replicated); plan: an ntt_mxu plan for the
    same n.  Returns the transformed (n, L) on every rank."""
    d, r = axis_rank(mesh, axis)
    n1, n2, L = plan.n1, plan.n2, x.shape[-1]
    if n1 % d or n2 % d:
        raise ValueError(f"a {n1} x {n2} transform does not split over {d} ranks")
    c2, c1 = n2 // d, n1 // d
    cols = slice(r * c2, (r + 1) * c2)
    xl = x.reshape(n1, n2, L)[:, cols].transpose(0, 1)  # (n2loc[i2], n1[i1], L)
    z = plan.steps_ab(xl[None], rows=cols)[0]  # (n2loc[i2], n1[o1], L)
    # the transpose: block j of o1 goes to rank j, which gets every rank's i2 block
    zt = all_to_all(mesh, axis, z.reshape(c2, d, c1, L).transpose(0, 1))  # (d[i2 block], c2, c1[o1], L)
    zc = zt.reshape(n2, c1, L).transpose(0, 1)  # (n1loc[o1], n2[i2], L)
    out = plan.step_c(zc[None])[0]  # (n1loc[o1], n2[o2], L)
    full = all_gather(mesh, axis, out).reshape(n1, n2, L)  # out[o1 + n1*o2] = full[o1, o2]
    return full.transpose(0, 1).reshape(x.shape)


def sharded_ntt(mesh: DeviceMesh, ntt, evals: torch.Tensor) -> torch.Tensor:
    """Batch-parallel inverse NTT: independent polynomials sharded over
    `voters`, the result gathered whole.  evals: (B, n, L) Montgomery
    limbs; one polynomial a voter (the within-polynomial axis is
    sharded_ntt4)."""
    d, r = axis_rank(mesh, "voters")
    part = ntt.intt(evals[_shard(evals.shape[0], d, r)])
    return all_gather(mesh, "voters", part).reshape(evals.shape)


# ---------------------------------------------------------------------------
# Ranks on this host
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankResult:
    """What one rank's fn returned (plain Python or numpy), with its wall
    seconds, the seconds from the spawn to its mesh being up (the process's
    start, imports, device and process group), the port's kernel launches
    in fn (``hopper_field.launches``) and the modules of JAX or the JAX
    package it had imported."""

    value: object
    seconds: float
    ready_s: float
    launches: dict
    foreign: list


def _rank_main(rank, n_points, n_voters, port, backend, device, call_path, queue, t_spawn):
    n = n_points * n_voters
    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            # NCCL: a card a rank; gloo: every rank on the card it was given
            torch.cuda.set_device(torch.device("cuda", rank % torch.cuda.device_count()) if backend == "nccl" else dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        with open(call_path, "rb") as f:  # written by spawn() in this run
            fn, args = pickle.load(f)
        # the rendezvous store is spawn()'s, which holds its port for the whole run
        store = dist.TCPStore("localhost", port, n, is_master=False)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n)
        mesh = make_mesh(n_points, n_voters, dev.type, backend)
        ready_s = time.time() - t_spawn
        before = dict(hf.launches)
        t0 = time.perf_counter()
        value = fn(mesh, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        dist.barrier()
        launches = {k: v - before[k] for k, v in hf.launches.items() if v != before[k]}
        foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
        queue.put((rank, True, RankResult(value, seconds, ready_s, launches, foreign)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, args=(), n_points: int = 1, n_voters: int = 1, device="cuda", backend: str | None = None,
          timeout: float = 900.0) -> list[RankResult]:
    """Run fn(mesh, *args) on the n_points x n_voters ranks of one mesh,
    each a spawned process of this host, and return their RankResults in
    rank order.  `fn` is a module-level function of the port, and `args`
    and its return value are plain Python or numpy.  On a card the kernels
    are built here first, and the ranks share `device` under gloo (the
    default where there are fewer cards than ranks) or take a card each
    under NCCL.  Any rank that raises or exits non-zero stops every rank,
    and its traceback is raised here."""
    n = n_points * n_voters
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = lb.device_of(dev)
        from ..ops import _build

        _build.load()
    backend = backend or default_backend(dev.type, n)
    with tempfile.TemporaryDirectory() as tmp:
        # fn and args go through a file: through a process's start pipe, a
        # large argument would hold each start until the rank before it had
        # imported everything, one rank after the other
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        return _run_ranks(n_points, n_voters, backend, dev, call_path, timeout)


def _run_ranks(n_points, n_voters, backend, dev, call_path, timeout) -> list[RankResult]:
    n = n_points * n_voters
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    # the ranks' rendezvous store lives here, on a port the OS assigns as it
    # binds, and the ranks join it as clients: a port found free and bound
    # only later by a rank could be taken in between (two spawns at once)
    store = dist.TCPStore("localhost", 0, None, True, wait_for_workers=False)
    port = store.port
    t_spawn = time.time()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, n_points, n_voters, port, backend, str(dev), call_path, queue, t_spawn))
             for rank in range(n)]
    results: dict[int, RankResult] = {}
    errors: list[str] = []

    def drain():
        while not queue.empty():
            rank, ok, payload = queue.get()
            if ok:
                results[rank] = payload
            else:
                errors.append(f"rank {rank} of {n} failed:\n{payload}")

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < n:
            drain()
            dead = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if errors or dead:
                time.sleep(0.2)
                drain()
                raise RuntimeError("\n".join(errors) or f"ranks exited with codes {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n - len(results)} of {n} ranks still running after {timeout} s")
            time.sleep(0.02)
        for i, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {i} exited with code {p.exitcode} after its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return [results[r] for r in range(n)]
