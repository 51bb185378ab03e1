#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``vote_saver_tpu_torch``).

Phases, in order; any failure exits non-zero, and there is no CPU fallback:

  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build the CUDA kernels from ``vote_saver_tpu_torch/csrc`` (one nvcc
     per translation unit, all at once);
  3. each kernel against its plain PyTorch version on the card (K1 at 2^16
     lanes in Fq and Fr in each multiplier mode, K2-K4 and the flagged
     distinct add K5/K6 at 2^14 lanes and the distinct add K3d at 2^16
     lanes, in G1 and G2; K3 in G2 as a team of threads a lane), special
     lanes included; exact equality; both timed.  K3d as setup's window sum
     (``window_sum``: a FixedBaseTable's 32 entries an output gathered and
     summed in one launch) at 2048 and 2^16 outputs on special digit rows,
     the loop instance at every team size (``check_window_sums``).  The chain kernels (K1's Fermat
     inversion ``mont_inv``, K4 with a count of doublings) also at the
     widths and counts the vote path gives them (``CHAIN_SHAPES``), and
     the MSM kernels (K2's bucket scan ``madd_scan``, K3's suffix round
     ``add_shift``) at the shapes of the vote path's MSMs and at 2^14 lanes
     (``MSM_SHAPES``), each row timed per call with CUDA events and per
     launch on the device with torch.profiler.  Every curve kernel and the
     inversion chain run each check in all three multiplier modes, loop, v1
     and fold (the v1 / fold instances logged as ``[modes]``), against one
     run of the plain version, which is the same function in every mode;
  4. a 2^16-point G1 MSM with uniform scalars at w = 10 against the native
     host MSM; then the same buckets, and those of a 2^14-point G2 MSM,
     through the combination phase once with the complete adder (K3) and
     once with the flagged distinct adder (K5/K6), both equal to the native
     MSM and both timed;
  4b. the multiply probes (``vote_saver_tpu_torch.micro``): K9's per-op
     rates, K1 in each multiplier mode, K7, K8 and K10, each with parity
     against the host oracle, and each timed launch held against its plain
     version on every lane; each chain probe's registers, local bytes,
     shared memory and resident warps a SM as the CUDA runtime reports
     them.  K7 and K8 in loop and v1 run the PTX carry chains
     (``csrc/mul_ptx.cuh``), and K7 runs again in the curve kernels'
     multiply as the yardstick (``k7_loop_c64``, ``k7_v1_c64``, in the
     kernels line too): ``[K7 forms]`` sets the two side by side, and
     ``[sass]`` gives each loop / v1 chain probe's instructions a multiply
     by class (``micro.sass_mix``).  K7 and K10 fold run their fold product on the int8 tensor
     cores, and so do the fold instances of the bucket scan, the suffix
     round, the doubling and the complete add in G1 and G2 (G2's the team
     add) and of the Fq and Fr inversion chains
     (``hopper_field.MMA_KERNELS``: ``g1_madd_scan_fold``,
     ``g1_double_fold``, ``g1_add_shift_fold``, ``g2_double_fold``,
     ``g2_madd_scan_fold``, ``g2_add_shift_fold``, ``g1_add_fold``,
     ``mont_inv_fr_fold``, ``mont_inv_fq_fold``, ``g2_add_fold``; their
     registers, local bytes, shared memory and warps a SM logged from the
     CUDA runtime in ``[kernels]`` and ``[modes]``): right after the build,
     ``cuobjdump -sass`` of the probe library and of the curve library
     must show IMMA and no IDP (dp4a) in all twelve, and the fold window
     sums (``DP4A_KERNELS``) IDP and no IMMA (``[sass]``);
  5. admin key generation for the depth-6 election on the card (Groth16
     setup through FixedBaseTable's window sum, one launch a group, and
     no single K3d launch): its five blobs byte-identical to the
     host-native arm's, both arms timed; the window sums' widths and the
     Fq inversions; once more under torch.profiler (loop): the device ms of
     each window sum;
  5b. the int8 matmul NTT (``ops/ntt_mxu.py``) at the vote path's shape,
     B = 16 rows of a 2^15 domain, and at depth 14's, B = 32 rows of a 2^16
     domain: each of the four kinds exactly equal to the radix-2 path on
     the card, both timed with CUDA events; at 2^15, each int8
     product (``torch._int_mm``, a library call: step A, step C, the fold)
     timed alone against its bound, its device kernels named by
     torch.profiler; one fold's device launches counted;
  6. depth-2 ballots for voters [0, 1, 2] of the committed election, byte
     for byte against ``tests/golden/torch_slice_d2.json``, through the
     default (device) vote arm and the host-witness arm, both on the
     default NTT path (the matmul NTT on the card);
  7. the vote phase at depth 6 with B = 16 voters (election cached under
     ``.torch_cache/``) through the device arm: one warm-up and two timed
     batches, every ballot verified, per-stage seconds, launches, int8
     products and peak device memory, then one timed batch of the
     host-witness arm and one of the device arm on the radix-2 NTT for
     comparison; then one more device-arm batch under torch.profiler:
     device time and launches per kernel, the launches of ``g2_add``,
     ``mont_mul_fr`` and ``g1_add`` by width, the int8 products' device
     time as library calls, and the device's busy share;
  7b. ``[path]``: the G2 and G1 complete adds at the vote path's widths
     (16, 32, G1's 480, the profiled batch's widest launch, and 2^14), in
     every multiplier mode, and K1 in Fr at the batch's large calls with their real tables
     (the COO products, the R1CS check, H, the matmul NTT's twiddle),
     against their plain versions, timed per call and per launch on the
     device;
  7c. ``[modes]``: under ``VSTPU_MUL=v1`` and then ``=fold`` (restored
     after), as a user selects a mode: depth-6 setup on the card against
     the host-native blobs; phase 7's first three device-arm batches again,
     from the same seed and votes, byte-identical to the loop mode's (the
     second timed by stage, the third under torch.profiler, the first two
     verified); the depth-2 golden through both arms; phase 4's buckets
     through the combination phase with both adders.  Each path launches
     every one of its kernels as the mode's instance and no instance of
     another mode;
  8. the tally of the first timed batch's 16 ballots (``tally_admin_phase``,
     ``tally_voter_phase``; host code): the counts equal that batch's
     votes, the proof verifies, a forged result is rejected, and no kernel
     of the port launches;
  9. the pipelined vote stream (``vote_with_context_stream``) over
     phase 7's three device-arm batches and STREAM_EXTRA more, under phase
     7's seed: byte-identical to phase 7's ballots and to sequential
     ``vote_with_context`` calls, timed against them in turns (sequential,
     stream, stream, sequential), the same kernel launches a pass; the
     synchronizing CUDA calls a batch of each, counted under
     ``torch.cuda.set_sync_debug_mode`` (and sequential calls' count with
     the vote path's uploads made blocking, as before the stream); one
     stream pass under torch.profiler (the device's busy share);
  10. ``vote_phase_batch`` (blobs in, ballots out) twice on the depth-6
     election from an empty parse cache: the seconds of each call's
     parse (the second parses nothing) and of each call, every ballot
     verified;
  11. Merkle trees on the card (``merkle.build_tree``: one Pedersen call a
     level, K1 in Fr) at depths 6 and 10, byte for byte against the oracle
     arm, both timed, and at depth 14 on the card only, its root and
     MERKLE_SAMPLES leaves and parents against the oracle: seconds,
     hashes/s, peak device memory and launches a depth;
  11b. ``[scale]``: BASELINE config 4 at its depth (14) and batch
     (B = 32), cut to 64 voters (config 3, depth 10, lies between [slice]'s
     depth 6 and this; ``scale.py`` runs it): setup on the card byte for byte
     against the host-native arm (keys cached under ``.torch_cache/``),
     then ``vote_saver_tpu_torch.scale.run`` through the stream from an
     empty cache (setup and the Merkle tree on the card, the parse, two
     batches, lanes 0 and 31 of each among the verified ballots, the
     tally, its check and its counts); every vote kernel launched on its
     batches, no single-row madd, H's transforms on the matmul NTT at
     2^16; seconds by phase and stage, launches a batch, peak
     device memory;
  12. the port's CLI over a depth-6 election in a temporary workdir, phase
     by phase (every voter's keys; setup and the tree on the card; one
     vote call of B = 16; their verification; the tally and its check;
     ``--phase bench``, B = 1), then on its artifacts the JSON service as a
     subprocess on the card (generate_vote, verify_vote, verify_tally; its
     stdout holding only response lines) and one generate_vote through the
     C ABI's function pointers: every ballot verified, each step timed;
  13. ``[sharded]``: ``entry.dryrun_multichip(4)`` on the one card (4
     gloo ranks, points 2 x voters 2: the sharded NTT, NTT4, MSM,
     scheduled MSM and tally against their unsharded results, and a
     depth-2 ``vote_with_context(mesh=)`` against the unsharded ballots),
     beside it ``vote_with_context(mesh=)`` at depth 6, B = 16 on 2 gloo
     ranks:
     each rank's ballots byte for byte [slice]'s first batch, a sample
     verified, every vote kernel launched on each rank; per rank wall
     seconds and launches, the backend and the transport;
  14. ``[chain]``: ``run_election`` at depth 6 with 16 voters on the card
     (the contracts, the chunked uploads, VERGRTH16): every ballot
     accepted, the counts equal to the votes, the observer's check true.

Every count of kernel launches is set to 0 just before a path runs (setup,
the combination phase through K5/K6, the probes, the timed device-arm
batches, each path of ``[modes]`` in each mode, the host-witness batch,
the tally, each pass of the stream and of its sequential comparison, each
``vote_phase_batch`` call, the Merkle trees, each ``[scale]`` run, each
CLI phase that votes or sets up, the C-ABI vote, each rank's run in
``[sharded]``, ``[chain]``'s election) and read just after it; the ``kernels`` line reports each kernel's count on its
path (a v1 or fold instance, K1's included: on that mode's path in
``[modes]``; K1 Fr's on the Merkle build, ``merkle_launches``; each vote
kernel's on ``[scale]``'s two batches at each depth, ``scale_launches``), and its
registers and spill bytes from ptxas's report.  A kernel of a path that launched 0 times fails
the run, and so does a launch of K2's single-row form on the vote path,
which runs the scan.  Each kernel's ``bound_ms`` is the larger of
its bytes over 3.35 TB/s and its operations over the card's rate for their
type: 32x32->64 multiply-adds (counted per lane from the formulas), 32-bit
multiplies and issued instructions over documented per-SM rates times the
SM count and the maximum SM clock (``micro.card_int_rates``; multiply-adds
at K9's measured rate where that is higher), float32 operations over 67
TFLOP/s, int8 products over 1,979 TOP/s.  The run imports nothing of JAX or
of the JAX package.  The ballots that phases 7-10 verify are each checked
in full by ``verify_ballot`` (host code) on a pool of spawned processes
(``verified``), terminated at exit.  The last two lines of stdout are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Needs one CUDA device:

    python3 chip_smoke.py
"""

from __future__ import annotations

import atexit
import concurrent.futures
import functools
import importlib.abc
import json
import multiprocessing
import os
import pathlib
import pickle
import random
import re
import sys
import threading
import time
import warnings
from collections import Counter

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0xC41B5
DEPTH, BATCH, EID_BITS = 6, 16, 64
K1_LANES, CURVE_LANES, FB_LANES = 1 << 16, 1 << 14, 1 << 16
MSM_N, MSM_W, MSM_G2_N = 1 << 16, 10, 1 << 14
# the kernels each path runs (a kernel of a path that never launched fails)
SETUP_KERNELS = ("g1_window_sum", "g2_window_sum", "mont_mul_fq", "mont_inv_fq")
# K3d's single distinct add: checked in [kernels], launched no time in setup, which runs the window sum
OFF_SETUP_PATH = ("g1_add_distinct", "g2_add_distinct")
VOTE_KERNELS = ("mont_mul_fq", "mont_mul_fr", "g1_madd_scan", "g2_madd_scan", "g1_add_shift", "g2_add_shift",
                "g1_add", "g2_add", "g1_double", "g2_double", "mont_inv_fq", "mont_inv_fr")
# K2's single-row form: checked in [kernels], launched no time on the vote path
OFF_VOTE_PATH = ("g1_madd", "g2_madd")
# the host-witness arm inverts nothing in Fr on the card (its witness is the host's)
HOST_ARM_KERNELS = tuple(k for k in VOTE_KERNELS if k != "mont_inv_fr")
# a vote of B = 1 runs no K1 in Fq: its ballot tail's 2B + 27B = 29 affine
# conversions are below curve_ops._DEVICE_AFFINE_MIN and run on the host
B1_KERNELS = tuple(k for k in VOTE_KERNELS if k not in ("mont_mul_fq", "mont_inv_fq"))
COMBINE_KERNELS = ("g1_addx", "g2_addx")
K1_MODE_KERNELS = ("mont_mul_fq_v1", "mont_mul_fr_v1", "mont_mul_fq_fold", "mont_mul_fr_fold")
# [modes]: the multiplier modes past loop (VSTPU_MUL), each with an instance
# of every curve kernel and of K1's Fermat chain (hopper_field.CURVE_KERNELS)
CURVE_MODES = ("v1", "fold")
# the kernels whose fold product runs on the int8 tensor cores (csrc/fold_mma.cuh):
# these probes, K7 and K10 fold, and the fold unit's instances hopper_field.MMA_KERNELS
FOLD_PROBES = ("mul_chain_k7_fold", "mul_chain_k10_fold")
# the built libraries [sass] reads for them
FOLD_UNITS = ("micro.cu", "curve_fold.cu")
# fold instances that keep the per-lane dp4a fold, whose [sass] must show IDP and no IMMA
DP4A_KERNELS = ("g1_window_sum_fold", "g2_window_sum_fold")
# the spin kernels (and their cycles each, about 0.25 ms) that open each profiling window (profile_window)
PROFILE_PAD, PAD_CYCLES = 32, 500_000
# what a profiling window's CUDA-event time may exceed its host time plus its kernels' device time by
# (the larger of the two; profile_window)
WINDOW_SLACK_MS, WINDOW_SLACK = 0.05, 0.05
# H100 SXM published peaks: HBM bytes/s, fp32 FLOP/s, int8 OP/s
HBM_BPS, F32_FLOPS, INT8_OPS = 3.35e12, 67e12, 1979e12
# 32x32->64 multiply-adds of one Fq / Fr Montgomery multiply: 2L^2 + L
MADS = {"fq": 2 * 12 * 12 + 12, "fr": 2 * 8 * 8 + 8}
# Fq multiplies per lane of each curve formula, G1 and G2 (an Fq2 square is
# 2 Fq multiplies, an Fq2 multiply 3): (squares, multiplies)
FORMULA = {"add": (5, 11), "madd": (4, 7), "double": (5, 2)}
# multiplies of k_mont_inv's chain: a square per bit of N - 2 below the top,
# a multiply per set bit below the top
INV_MULS = {"fq": 380 + 228, "fr": 254 + 163}
# (lanes, doublings) the depth-6 B = 16 vote path gives the chain kernels,
# the first of each being its kernels-line row: the device witness inverts
# B = 16 lanes in Fr; the ballot tail's affine conversion 2B + B(25 + 2) =
# 464 lanes in Fq; Horner 10 doublings on the B parts of an MSM; the tail's
# windowed multiplies 4 on B(25 + 5) = 480 (G1) and 2B = 32 (G2) lanes.
# Also inversions at 2^16 lanes and 10 doublings at 480 lanes, for scale.
CHAIN_SHAPES = {
    "mont_inv_fr": ((16, 1), (1 << 16, 1)),
    "mont_inv_fq": ((464, 1), (16, 1), (1 << 16, 1)),
    "g1_double": ((16, 10), (480, 4), (480, 10)),
    "g2_double": ((16, 10), (32, 4), (480, 10)),
}
# the MSM kernels at the vote path's shapes, the first of each being its
# kernels-line row: the bucket scan over the h MSM's schedule (16 parts of
# 2^15 - 1 scalars at w = 10: 80 rows of 248,832 lanes; None = every lane)
# and, in G2, its first 32 rows, the shape of the b2 MSM's; the suffix
# round over the 16 x 27 windows of 512 buckets at the smallest and largest
# shift.  Also 2^14 lanes of each, for the kernel table.
MSM_SHAPES = {
    "g1_madd_scan": ((80, None), (80, 1 << 14)),
    "g2_madd_scan": ((32, None), (32, 1 << 14)),
    "g1_add_shift": ((432, 512, 1), (432, 512, 256), (32, 512, 1)),
    "g2_add_shift": ((432, 512, 1), (432, 512, 256), (32, 512, 1)),
}
H_POINTS = (1 << 15) - 1  # the h query's points: the affine table the scan reads
# setup's window sum: the special and random rows of testing.window_scalars, and the same rows
# drawn at random positions at the width of a large setup group (depth 6: 85,6xx G1, 17,6xx G2)
WINDOW_ROWS, WINDOW_WIDE = 2048, 1 << 16
# [path]: the widths of the vote path's complete adds (the MSMs' Horner steps,
# the ballot tail's windowed multiplies and affine sums; the batch's largest
# orphan merge joins them from [profile]) and 2^14 lanes
ADD_WIDTHS = {"g2_add": (16, 32, CURVE_LANES), "g1_add": (16, 32, 480, CURVE_LANES)}
# the kernels whose launch widths [profile] gives a batch
WIDTH_KERNELS = ("g2_add", "mont_mul_fr", "g1_add")
# the matmul NTT at the vote path's shape: B = 16 rows of the depth-6 2^15 domain;
# a batch runs 3 inv + 3 fwd_coset + 1 inv_coset transforms
NTT_N, NTT_B = 1 << 15, 16
# and at depth 14's: B = 32 rows of a 2^16 domain (BASELINE config 4), each kind against radix-2
NTT_WIDE_N, NTT_WIDE_B = 1 << 16, 32
NTT_KINDS = (("fwd", "ntt"), ("inv", "intt"), ("fwd_coset", "coset_ntt"), ("inv_coset", "coset_intt"))
NTT_PER_BATCH = 7
# [stream]: batches past [slice]'s three device-arm ones, and the batches
# whose synchronizing calls are counted
STREAM_EXTRA, SYNC_BATCHES = 2, 2
# [merkle]: trees built on the card and through the oracle, byte for byte
# (BASELINE configs 2 and 3), and the tree built on the card only (config 4),
# checked at MERKLE_SAMPLES leaves and parents against the oracle
MERKLE_DEPTHS, MERKLE_DEEP, MERKLE_SAMPLES = (DEPTH, 10), 14, 64
# the Pedersen hash's kernels: K1 in Fr, its multiply and its Fermat chain
MERKLE_KERNELS = ("mont_mul_fr", "mont_inv_fr")
# [scale]: BASELINE config 4 (depth 14, B = 32) cut to 64 voters, two stream batches; the
# voters verified (lanes 0 and 31 of each batch among them); H's domain at the depth
SCALE_CONFIGS, SCALE_VOTERS = (4,), 64
SCALE_VERIFY = (0, 11, 22, 31, 32, 43, 54, 63)
SCALE_DOMAIN = {14: 1 << 16}
# [sharded]: the points axis of the depth-6 vote's mesh (gloo ranks on the one card), and
# the voters of that batch verified
SHARDED_POINTS, SHARDED_VERIFY = 2, (0, BATCH - 1)
# [chain]: run_election's voters at DEPTH
CHAIN_VOTERS = BATCH


class _NoJax(importlib.abc.MetaPathFinder):
    """The port runs without JAX and without the JAX package: importing
    either here is an error (``vote_saver_tpu_torch`` is the port itself)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "vote_saver_tpu"):
            raise ImportError(f"{name} imported on the port's path")
        return None


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def _verify(args) -> bool:
    """verify_ballot(proof, pinput, ct, vk_eid, vk_crs), in a worker process."""
    from vote_saver_tpu_torch.protocol import phases

    return phases.verify_ballot(*args)


@functools.cache
def _verify_pool():
    """The processes verify_ballot runs on (host code: pairings and affine
    multiplies, about a second a ballot), terminated at exit."""
    pool = multiprocessing.get_context("spawn").Pool(max(1, len(os.sched_getaffinity(0)) - 1))
    atexit.register(pool.terminate)
    return pool


def verified(ballots, vk_eid: bytes, vk_crs: bytes) -> int:
    """How many of `ballots` pass verify_ballot, every one checked in full,
    spread over the worker processes."""
    return sum(_verify_pool().map(_verify, [(b[0], b[1], b[2], vk_eid, vk_crs) for b in ballots]))


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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _finite(*zs):
    """Lanes where every given Z coordinate is nonzero (finite points)."""
    import torch

    out = None
    for z in zs:
        nz = (z.reshape(z.shape[0], -1) != 0).any(dim=1)
        out = nz if out is None else out & nz
    return int(out.sum())


def _curve_mads(kind: str, g2: bool, lanes: int) -> int:
    sq, mul = FORMULA[kind]
    return lanes * (sq * 2 + mul * 3 if g2 else sq + mul) * MADS["fq"]


def mode_work(work: dict, mode: str, field: str = "fq") -> dict:
    """The work a kernel's bound counts in `mode`: the function's, its loop
    work (bytes and 2L^2 + L multiply-adds a multiply), in every mode.  In
    fold it also holds, under "fold", the fold algorithm's own work, whose
    bound is logged beside: for each of the mads / MADS[field] multiplies,
    K1 fold's (its row in check_kernels), the fp32 digit columns, the
    fold's int8 products and its word steps."""
    from vote_saver_tpu_torch.ops import fold_mul
    from vote_saver_tpu_torch.ops import limbs as lb

    if mode != "fold":
        return dict(work)
    p = fold_mul.plan(lb.spec_for(field))
    muls = work["mads"] // MADS[field]
    return dict(work, fold=dict(bytes=work["bytes"], f32_flops=muls * 2 * p["nd"] ** 2,
                                int8_ops=muls * 2 * p["mat"].size, mads=muls * 2 * (p["L"] + 1)))


def fold_bound(work: dict, rates: dict) -> str:
    """The fold algorithm's bound where `work` holds it (mode_work), as
    logged beside a fold instance's bound, else ''."""
    if "fold" not in work:
        return ""
    ms, by = bound(work["fold"], rates)
    return f"; the fold algorithm's bound {ms:.5f} ms ({by})"


def profile_window(fn, reps: int = 1, warm: bool = False):
    """The one way this script and chip_ab.py profile: `reps` calls of fn
    (after one unprofiled call where `warm`) under torch.profiler's CUDA
    activity -> (fn's last result, [(name,
    device us)] of the device kernels the calls launched), the list None
    where the window lost records.  torch.profiler (Kineto over CUPTI) may
    drop the records of a session's first kernels: in a long run of this
    script (never in a fresh process) it dropped 3 to 5 a session (every
    launch of a suffix round's rows at 432 x 512, which profiled 3 calls of
    a wrapper that launches its kernel alone), and from the NTT phase on
    often more than 8 spin kernels of 1,000 cycles.  So the window opens
    with PROFILE_PAD spin kernels (torch.cuda._sleep, about 8 ms in all),
    finished before the calls start, and keeps the kernels that start after
    the last pad recorded.  Where no pad was
    recorded the drop may have reached the calls, and where the port's
    kernels recorded (kernel_key) differ in number from the launches
    hopper_field counted during the calls, records were lost: both give
    None, and a log line.  So does a window whose CUDA events span more
    than the host's time issuing the calls plus every kernel's recorded
    device time (and WINDOW_SLACK): the card is either running a kernel
    or waiting for the host, so its records are short or lost (a chain
    kernel of 0.83 ms once read 0.57 ms a launch, every record present)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vote_saver_tpu_torch.ops import hopper_field as hf

    if warm:
        fn()
        torch.cuda.synchronize()
    result = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        before = sum(hf.launches.values())
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            result = fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev1.record()
        torch.cuda.synchronize()
        launched = sum(hf.launches.values()) - before
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    pads = [e for e in kernels if "spin_kernel" in e.name]
    if not pads:
        log(f"[profile] window of {reps} calls: no pad kernel recorded, so its records may be lost; not measured")
        return result, None
    start = max(e.time_range.end for e in pads)
    out = [(e.name, e.time_range.elapsed_us()) for e in kernels
           if e.time_range.start >= start and "spin_kernel" not in e.name]
    ours = sum(kernel_key(name) is not None for name, _us in out)
    if ours != launched:
        log(f"[profile] window of {reps} calls: {ours} of the port's kernels recorded, {launched} launched; "
            f"not measured")
        return result, None
    window_ms, busy_ms = ev0.elapsed_time(ev1), sum(us for _name, us in out) / 1e3
    if window_ms > host_ms + busy_ms + max(WINDOW_SLACK_MS, WINDOW_SLACK * window_ms):
        log(f"[profile] window of {reps} calls: {window_ms:.4f} ms by CUDA events against the host's {host_ms:.4f} ms "
            f"and {busy_ms:.4f} ms of kernels recorded; not measured")
        return result, None
    return result, out


def device_ms(fn, reps: int, family: str):
    """Mean device milliseconds per launch of the kernels whose name holds
    `family` over `reps` calls of fn (profile_window); None where the
    window lost records or holds none of them."""
    _r, events = profile_window(fn, reps, warm=True)
    us = [t for name, t in events or () if family in name]
    return sum(us) / len(us) / 1e3 if us else None


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def check_chains(rnd, points: dict) -> dict:
    """The chain kernels at CHAIN_SHAPES against their plain versions, in
    every multiplier mode (one plain run a shape: it is the same function in
    every mode): mont_inv on 0, 1, N - 1, R mod N and random lanes; the
    doublings on the first lanes of check_kernels' special lanes (lane 0
    canonical infinity).  Each row, under the instance's name: equality,
    the event-timed ms per call (wrapper and launch included), the
    profiler's device ms per launch, the plain ms and the work its bound is
    computed from."""
    import torch

    from vote_saver_tpu_torch.micro import time_ms
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb

    out = {}
    for kname, shapes in CHAIN_SHAPES.items():
        for lanes, times in shapes:
            if kname.startswith("mont_inv"):
                name = field = kname[-2:]
                spec = lb.spec_for(name)
                N = spec.modulus
                xs = [0, 1, N - 1, spec.mont_r % N] + [rnd.randrange(N) for _ in range(lanes - 4)]
                a = lb.ints_to_tensor(xs, spec, "cuda")
                ins = (a,)
                kern = lambda mode, name=name, a=a: (hf.mont_inv(name, a, mode),)  # noqa: E731
                plain = lambda name=name, a=a: (hf.mont_inv_plain(name, a),)  # noqa: E731
                mads = lanes * INV_MULS[name] * MADS[name]
                family = "k_mont_inv"
            else:
                g2, field = kname.startswith("g2"), "fq"
                ins = tuple(c[:lanes].contiguous() for c in points[g2])
                dbl = hf.g2_double if g2 else hf.g1_double
                kern = lambda mode, dbl=dbl, ins=ins, times=times: dbl(ins, times, mode)  # noqa: E731
                plain = lambda g2=g2, ins=ins, times=times: hf.double_plain(g2, ins, times)  # noqa: E731
                mads = times * _curve_mads("double", g2, lanes)
                family = "k_double"
            exp = plain()
            reps = 20 if lanes <= 1024 else 5
            plain_ms = time_ms(plain, 1 if lanes > 1024 else 3)
            for mode in hf.MODES:
                inst = hf.instance(kname, mode)
                run = lambda kern=kern, mode=mode: kern(mode)  # noqa: E731
                got = run()
                torch.cuda.synchronize()
                if kname.startswith("mont_inv") and list(lb.tensor_to_ints(got[0][:64], spec)) != [
                        pow(x, N - 2, N) for x in xs[:64]]:
                    fail(f"{inst} at {lanes} lanes disagrees with Python integers")
                work = mode_work(dict(bytes=_nbytes(*ins, *got), mads=mads), mode, field)
                row = dict(lanes=lanes, times=times, equal=all(torch.equal(x, y) for x, y in zip(got, exp)),
                           max_abs_err=_diff(got, exp), ms=time_ms(run, reps), device_ms=device_ms(run, reps, family),
                           plain_ms=plain_ms, work=work)
                log(f"[{'kernels' if mode == 'loop' else 'modes'}] {inst}: lanes={lanes} times={times} "
                    f"equal={row['equal']} max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms a call, "
                    f"device {_ms(row['device_ms'])} a launch, plain {row['plain_ms']:.3f} ms")
                if not row["equal"]:
                    fail(f"{inst} at {lanes} lanes x {times} disagrees with its plain version")
                out.setdefault(inst, []).append(row)
    return out


def check_kernels(rnd) -> dict:
    """Each kernel against its plain version, the curve kernels and the
    chains in every multiplier mode (the plain version runs once for all
    three: it is the same function in each).  Besides the times, each
    result carries the work that its bound is computed from: bytes read and
    written once, and the operations these inputs need (lanes with an
    infinite operand or an inactive madd lane take the formula's early exit
    and count no multiplies; the handful of h = 0 lanes count as generic)."""
    import torch

    from vote_saver_tpu_torch.micro import time_ms
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.testing import ADDX_EXC, MADD_EXC, special_lanes

    dev = torch.device("cuda")
    results, points = {}, {}
    for name, spec in (("fq", lb.FQ), ("fr", lb.FR)):
        N = spec.modulus
        rinv = pow(spec.mont_r, -1, N)
        # limbs 0, R mod N, N - R, then raw limbs 1 and N - 1 (Montgomery ints
        # R^-1 and (N - 1) R^-1), then random
        xs = [0, 1, N - 1, N - 1, rinv, (N - 1) * rinv % N] + [rnd.randrange(N) for _ in range(K1_LANES - 6)]
        ys = [N - 1, 1, N - 1, 0, rinv, (N - 1) * rinv % N] + [rnd.randrange(N) for _ in range(K1_LANES - 6)]
        a, b = lb.ints_to_tensor(xs, spec, dev), lb.ints_to_tensor(ys, spec, dev)
        want = [x * y % N for x, y in zip(xs[:64], ys[:64])]
        loop = None
        for mode in hf.MODES:
            kname = f"mont_mul_{name}" + ("" if mode == "loop" else f"_{mode}")
            got = hf.mont_mul(name, a, b, mode)
            exp = hf.mont_mul_plain(name, a, b, mode)
            torch.cuda.synchronize()
            if list(lb.tensor_to_ints(got[:64], spec)) != want:
                fail(f"{kname} disagrees with Python integers")
            loop = got if loop is None else loop
            if not torch.equal(got, loop):
                fail(f"{kname} disagrees with the loop mode")
            work = mode_work(dict(bytes=_nbytes(a, b, got), mads=K1_LANES * MADS[name]), mode, name)
            results[kname] = dict(
                equal=torch.equal(got, exp), max_abs_err=_diff((got,), (exp,)),
                ms=time_ms(lambda: hf.mont_mul(name, a, b, mode), 50),
                plain_ms=time_ms(lambda: hf.mont_mul_plain(name, a, b, mode), 3),
                lanes=K1_LANES, work=work,
            )
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        p, q, acc, qa, sign, active = special_lanes(g2, CURVE_LANES, rnd)
        P, Qd = _to_dev(zip(*p), dev), _to_dev(zip(*q), dev)
        points[g2] = P
        A, QA = _to_dev(zip(*acc), dev), _to_dev(zip(*qa), dev)
        S = torch.tensor(sign, device=dev)
        ACT = torch.tensor(active, device=dev)
        madd = hf.g2_madd if g2 else hf.g1_madd
        add = hf.g2_add if g2 else hf.g1_add
        dbl = hf.g2_double if g2 else hf.g1_double
        addx = hf.g2_addx if g2 else hf.g1_addx
        # (kernel in a mode, plain version): the plain version is the same in every mode
        cases = {
            f"{pre}_madd": (lambda m: madd(A, QA, S, ACT, mode=m), lambda: hf.madd_plain(g2, A, QA, S, ACT)),
            f"{pre}_add": (lambda m: add(P, Qd, mode=m), lambda: hf.add_plain(g2, P, Qd)),
            f"{pre}_double": (lambda m: dbl(P, mode=m), lambda: hf.double_plain(g2, P)),
            f"{pre}_addx": (lambda m: addx(P, Qd, mode=m), lambda: hf.addx_plain(g2, P, Qd)),
        }
        # K3d at the FixedBaseTable width: the special lanes, four times over
        P4, Q4 = (tuple(torch.cat([c] * (FB_LANES // CURVE_LANES)) for c in pts) for pts in (P, Qd))
        addd = hf.g2_add_distinct if g2 else hf.g1_add_distinct
        cases[f"{pre}_add_distinct"] = (lambda m: addd(P4, Q4, mode=m), lambda: hf.add_distinct_plain(g2, P4, Q4))
        live_madd = int((ACT & ~((A[2] == 0).reshape(CURVE_LANES, -1).all(dim=1))
                         & ~((QA[0] == 0) & (QA[1] == 0)).reshape(CURVE_LANES, -1).all(dim=1)).sum())
        work = {
            f"{pre}_madd": dict(mads=_curve_mads("madd", g2, live_madd)),
            f"{pre}_add": dict(mads=_curve_mads("add", g2, _finite(P[2], Qd[2]))),
            f"{pre}_double": dict(mads=_curve_mads("double", g2, CURVE_LANES)),
            f"{pre}_addx": dict(mads=_curve_mads("add", g2, _finite(P[2], Qd[2]))),
            f"{pre}_add_distinct": dict(mads=_curve_mads("add", g2, _finite(P4[2], Q4[2]))),
        }
        for kname, (kern, plain) in cases.items():
            exp = plain()
            if kname.endswith("madd") or kname.endswith("addx"):
                exp = (*exp[0], exp[1])
            plain_ms = time_ms(plain, 3)
            flat_in = (*A, *QA, S, ACT) if kname.endswith("madd") else (
                (*P4, *Q4) if kname.endswith("distinct") else (*P, *Qd) if not kname.endswith("double") else P)
            for mode in hf.MODES:
                inst = hf.instance(kname, mode)
                run = lambda kern=kern, mode=mode: kern(mode)  # noqa: E731
                got = run()
                if kname.endswith("madd") or kname.endswith("addx"):
                    got = (*got[0], got[1])
                    flags = got[-1][: len(MADD_EXC)].tolist()
                    if flags != (MADD_EXC if kname.endswith("madd") else ADDX_EXC):
                        fail(f"{inst} exc flags on the special lanes: {flags}")
                if kname.endswith("distinct") and (got[2][3].any() or got[2][4].any()):
                    fail(f"{inst}: the h = 0 lanes do not give z3 = 0")
                if kname.endswith("addx") and (got[2][3].any() or got[2][4].any() or got[2][5].any()):
                    fail(f"{inst}: the p = q and p = -q lanes do not give z3 = 0")
                torch.cuda.synchronize()
                results[inst] = dict(
                    equal=all(torch.equal(x, y) for x, y in zip(got, exp)),
                    max_abs_err=_diff(got, exp),
                    ms=time_ms(run, 20), plain_ms=plain_ms,
                    lanes=FB_LANES if kname.endswith("distinct") else CURVE_LANES,
                    work=mode_work(dict(work[kname], bytes=_nbytes(*flat_in, *got)), mode),
                )
        # K5/K6 at the K3d width, beside K3d in the same call
        ms4 = time_ms(lambda: addx(P4, Q4), 20)
        log(f"[kernels] {pre}_addx at {FB_LANES} lanes: {ms4:.4f} ms (K3d {results[f'{pre}_add_distinct']['ms']:.4f} ms)")
    for kname, r in results.items():
        log(f"[{'modes' if hf.mode_of(kname) != 'loop' and kname not in K1_MODE_KERNELS else 'kernels'}] "
            f"{kname}: lanes={r['lanes']} equal={r['equal']} max_abs_err={r['max_abs_err']} "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms")
        if not r["equal"]:
            fail(f"{kname} kernel disagrees with its plain version")
    for kname, rows in check_chains(rnd, points).items():
        main = {k: rows[0][k] for k in ("equal", "max_abs_err", "ms", "plain_ms", "lanes", "work")}
        results.setdefault(kname, main)["chains"] = rows
    for kname, rows in (*check_msm_kernels(rnd).items(), *check_window_sums(rnd).items()):
        results[kname] = dict({k: rows[0][k] for k in ("equal", "max_abs_err", "ms", "plain_ms", "lanes", "work")},
                              shapes=rows)
    for kname in hf.MMA_KERNELS:
        info = log_mma_info(kname)
        results[kname].update(smem_bytes=info["smem_bytes"], warps_per_sm=info["warps_per_sm"])
    return results


def log_mma_info(kname: str) -> dict:
    """Logs what the CUDA runtime reports of the tensor-core instance kname
    (hopper_field.MMA_KERNELS) and returns it."""
    from vote_saver_tpu_torch.ops import hopper_field as hf

    info = hf.mma_info(kname)
    log(f"[modes] {kname}: {info['registers']} registers, {info['local_bytes']} B local memory a thread, "
        f"{info['smem_bytes']} B shared memory a block, {info['blocks_per_sm']} blocks = "
        f"{info['warps_per_sm']} warps a SM (CUDA runtime)")
    return info


def _msm_inputs(g2: bool, rnd, dev):
    """The scan's table and codes and the suffix grid, on the card: the h
    schedule's codes over a table of H_POINTS random field elements, with
    testing.scan_lanes' special lanes in lanes 0-6 (their points at the
    table's first indices); a grid of random finite points with
    testing.shift_grid's special lanes in the first 16 of row 0."""
    import torch

    from vote_saver_tpu_torch import testing
    from vote_saver_tpu_torch.micro import random_limbs
    from vote_saver_tpu_torch.ops import msm_sched as ms

    L = 12
    gen = torch.Generator(device=dev).manual_seed(SEED + g2)
    tail = (2, L) if g2 else (L,)
    table = [random_limbs("fq", H_POINTS * len(tail), dev, gen).reshape((H_POINTS,) + tail) for _ in range(2)]
    spts, scodes = testing.scan_lanes(g2, 24, 7, 4, rnd)
    sxy = (ms.g2_affine_to_device if g2 else ms.g1_affine_to_device)(spts, dev)
    for t, s in zip(table, sxy):
        t[: len(spts)] = s
    codes = torch.from_numpy(testing.h_schedule(SEED).codes).to(dev)
    codes[:, :7] = 0
    codes[:4, :7] = torch.from_numpy(scodes).to(dev)
    grid = [random_limbs("fq", 432 * 512 * len(tail), dev, gen).reshape((432, 512) + tail) for _ in range(3)]
    special = testing.shift_grid(g2, 1, 16, rnd)
    for k, c in enumerate(grid):
        c[0, :16] = _to_dev([[pt[k] for pt in special]], dev)[0]
    return tuple(table), codes, tuple(grid)


def check_msm_kernels(rnd, dev="cuda") -> dict:
    """The bucket scan and the suffix round at MSM_SHAPES against their
    plain versions on the same inputs, in every multiplier mode (one plain
    run a shape; the scan's special lanes must flag as testing.SCAN_EXC):
    equality, the event-timed ms a call, the
    profiler's device ms a launch, the plain version's ms (one call: at the
    path's shapes it takes seconds) and the work the bound counts: the
    scan's madds past each lane's first entry (which lifts its point) and
    the rounds' adds with a partner."""
    import torch

    from vote_saver_tpu_torch.micro import time_ms, timed
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.testing import SCAN_EXC

    out = {}
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        table, codes, grid = _msm_inputs(g2, rnd, torch.device(dev))
        scan = hf.g2_madd_scan if g2 else hf.g1_madd_scan
        shift_add = hf.g2_add_shift if g2 else hf.g1_add_shift
        for kname in (f"{pre}_madd_scan", f"{pre}_add_shift"):
            for shape in MSM_SHAPES[kname]:
                if kname.endswith("scan"):
                    steps, lanes = shape
                    c = codes[:steps, :lanes].contiguous()
                    kern = lambda mode, c=c: scan(table, c, mode=mode)  # noqa: E731
                    plain = lambda c=c: hf.madd_scan_plain(g2, table, c)  # noqa: E731
                    live = c != 0
                    mads = _curve_mads("madd", g2, int(live.sum()) - int(live.any(dim=0).sum()))
                    ins, lanes = (*table, c), c.shape[1]
                    family, desc = "k_madd_scan", f"{steps} rows x {lanes} lanes"
                else:
                    nrows, bw, shift = shape
                    gr = tuple(t[:nrows].contiguous() for t in grid)
                    kern = lambda mode, gr=gr, shift=shift: shift_add(gr, shift, mode=mode)  # noqa: E731
                    plain = lambda gr=gr, shift=shift: hf.add_shift_plain(g2, gr, shift)  # noqa: E731
                    fin = (gr[2] != 0).reshape(nrows, bw, -1).any(dim=-1)
                    pairs = fin[:, : bw - shift] & fin[:, shift:] if shift < bw else fin[:, :0]
                    mads = _curve_mads("add", g2, int(pairs.sum()))
                    ins, lanes = gr, nrows * bw
                    family, desc = "k_add_shift", f"{nrows} x {bw} shift {shift}"
                exp, plain_ms = timed(plain)
                if kname.endswith("scan"):
                    exp = (*exp[0], exp[1])
                reps = 3 if lanes > (1 << 14) else 10
                for mode in hf.MODES:
                    inst = hf.instance(kname, mode)
                    run = lambda kern=kern, mode=mode: kern(mode)  # noqa: E731
                    got = run()
                    if kname.endswith("scan"):
                        got = (*got[0], got[1])
                        if got[-1][: len(SCAN_EXC)].tolist() != SCAN_EXC:
                            fail(f"{inst} exc flags on the special lanes: {got[-1][: len(SCAN_EXC)].tolist()}")
                    work = mode_work(dict(bytes=_nbytes(*ins, *got), mads=mads), mode)
                    row = dict(shape=list(shape), lanes=lanes, equal=all(torch.equal(x, y) for x, y in zip(got, exp)),
                               max_abs_err=_diff(got, exp), ms=time_ms(run, reps),
                               device_ms=device_ms(run, reps, family), plain_ms=plain_ms, work=work)
                    log(f"[{'kernels' if mode == 'loop' else 'modes'}] {inst}: {desc} equal={row['equal']} "
                        f"max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms a call, device "
                        f"{_ms(row['device_ms'])} a launch, plain {plain_ms:.1f} ms")
                    if not row["equal"]:
                        fail(f"{inst} at {desc} disagrees with its plain version")
                    out.setdefault(inst, []).append(row)
                    del got
                del exp
    return out


def window_adds(digits) -> int:
    """The adds of the window sum's tree (pairs of windows, then pairs of
    those, ...) whose operands are both finite on these digit rows: an
    infinite operand (digit 0, or a subtree of zero digits) takes the
    formula's select and no multiply."""
    import numpy as np

    live = np.asarray(digits) != 0
    adds = 0
    while live.shape[1] > 1:
        a, b = live[:, 0::2], live[:, 1::2]
        adds += int((a & b).sum())
        live = a | b
    return adds


def check_window_sums(rnd, dev="cuda") -> dict:
    """Setup's window sum (K3d as FixedBaseTable.mul repeats it) against
    window_sum_plain in every multiplier mode, at every team size the mode
    builds (loop: 1, 2, 4, 8; v1 and fold: WINDOW_TEAM): WINDOW_ROWS rows
    of testing.window_scalars, and WINDOW_WIDE rows drawn from them at
    random positions, whose plain result is the WINDOW_ROWS rows' drawn
    the same way (the sum is row by row; the plain version at 2^16 rows
    takes a minute in G2).  Each row: equality, the event-timed ms a call,
    the profiler's device ms a launch (WINDOW_TEAM), the plain ms (at
    WINDOW_ROWS) and the work the bound counts: the table, digits and
    outputs once, and the tree's adds with both operands finite."""
    import torch

    from vote_saver_tpu_torch.micro import time_ms, timed
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import msm
    from vote_saver_tpu_torch.refimpl import curves as rc
    from vote_saver_tpu_torch.testing import window_scalars

    out = {}
    for g2 in (False, True):
        pre = "g2" if g2 else "g1"
        tbl = msm.FixedBaseTable(rc.g2_gen if g2 else rc.g1_gen, pre)
        table = tuple(c.to(dev) for c in tbl.table)
        rows = tbl.digits(window_scalars(WINDOW_ROWS, rnd))
        perm = torch.randint(0, WINDOW_ROWS, (WINDOW_WIDE,), generator=torch.Generator().manual_seed(rnd.randrange(
            1 << 30)))
        digits = torch.from_numpy(rows).to(dev)
        exp, plain_ms = timed(lambda: hf.window_sum_plain(g2, table, digits))
        cases = ((digits, exp, plain_ms, window_adds(rows)),
                 (digits[perm.to(dev)].contiguous(), tuple(c[perm.to(dev)] for c in exp), None,
                  window_adds(rows[perm.numpy()])))
        fn = hf.g2_window_sum if g2 else hf.g1_window_sum
        for mode in hf.MODES:
            inst = hf.instance(f"{pre}_window_sum", mode)
            teams = (hf.WINDOW_TEAM, 1, 2, 8) if mode == "loop" else (hf.WINDOW_TEAM,)
            for team in teams:
                for d, want, p_ms, adds in cases:
                    n = d.shape[0]
                    run = lambda d=d, mode=mode, team=team: fn(table, d, checked=True, mode=mode, team=team)  # noqa: E731
                    got = run()
                    torch.cuda.synchronize()
                    reps = 20 if n <= WINDOW_ROWS else 3 if mode == "fold" else 10
                    work = mode_work(dict(bytes=_nbytes(*table, d, *got), mads=_curve_mads("add", g2, adds)), mode)
                    row = dict(shape=[n, team], lanes=n, team=team, equal=all(torch.equal(x, y) for x, y in zip(got, want)),
                               max_abs_err=_diff(got, want), ms=time_ms(run, reps),
                               device_ms=device_ms(run, reps, "k_window_sum") if team == hf.WINDOW_TEAM else None,
                               plain_ms=p_ms, work=work)
                    log(f"[{'kernels' if mode == 'loop' else 'modes'}] {inst}: {n} outputs, team {team}: "
                        f"equal={row['equal']} max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms a call, "
                        f"device {_ms(row['device_ms'])} a launch"
                        + ("" if p_ms is None else f", plain {p_ms:.1f} ms"))
                    if not row["equal"]:
                        fail(f"{inst} at {n} outputs, team {team}, disagrees with its plain version")
                    out.setdefault(inst, []).append(row)
    return out


# ---------------------------------------------------------------------------
# Phase 4: 2^16 G1 MSM against the native host MSM
# ---------------------------------------------------------------------------


def check_msm(rnd) -> dict:
    import torch

    from vote_saver_tpu_torch import native_bridge as nb
    from vote_saver_tpu_torch.ops import curve_ops as co
    from vote_saver_tpu_torch.ops import msm_sched as ms
    from vote_saver_tpu_torch.params import R
    from vote_saver_tpu_torch.refimpl import curves as rc
    from vote_saver_tpu_torch.refimpl import jacobian as rj

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
    want = nb.msm(pts, scalars)
    if bool(exc) or got != want:
        fail("2^16 G1 MSM does not match native_bridge.msm")
    out = dict(n=MSM_N, w=MSM_W, ms=dt * 1e3, mpoints_per_s=MSM_N / dt / 1e6, sched_host_ms=sched_ms,
               steps=int(sched.codes.shape[0]), lanes=int(sched.lanes))
    log(f"[msm] 2^16 G1 w=10: {out['ms']:.2f} ms = {out['mpoints_per_s']:.4f} Mpoints/s "
        f"(steps={out['steps']} lanes={out['lanes']} host schedule {sched_ms:.1f} ms); matches native")
    g2_pts = rj.FixedBaseHost(rc.g2_gen, "g2").mul_many([rnd.randrange(1, R) for _ in range(MSM_G2_N)])
    g2_scalars = [rnd.randrange(R) for _ in range(MSM_G2_N)]
    g2_sched = ms.build_schedule(g2_scalars, MSM_W)
    cases = (("g1", MSM_N, pxy, sched, want),
             ("g2", MSM_G2_N, ms.g2_affine_to_device(g2_pts, "cuda"), g2_sched,
              nb.msm(g2_pts, g2_scalars, group="g2")))
    out["combine"] = check_combination(cases)
    out["cases"] = cases  # [modes] runs them again in each mode
    return out


def check_combination(cases, mode: str = "loop") -> dict:
    """One set of buckets per MSM through the combination phase, once with
    the complete adder and once with the flagged distinct adder K5/K6, in
    the process's multiplier mode, which is `mode` (the kernels that must
    launch are its instances).  With uniform scalars every bucket below a
    window's top digit is non-empty, so the flag is expected clear; if it
    fires, the flagged lanes are counted and the complete adder's result is
    taken, as ``msm_scheduled``'s fallback does.  Launch counts are set to
    0 just before each run and read just after it."""
    import torch

    from vote_saver_tpu_torch.ops import curve_ops as co
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import msm_sched as ms

    out = {}
    for group, n, pxy, sched, want in cases:
        from_dev = co.g2_from_device if group == "g2" else co.g1_from_device
        buckets, bexc = ms.bucket_phase(group, pxy, sched)
        if bool(bexc):
            fail(f"{group} bucket phase hit the madd doubling corner")
        r = {}
        for adder, distinct in (("complete", False), ("addx", True)):
            # the complete adder's suffix rounds run as K3's shift form, as on the vote path
            addx, add_shift = ms._addx(group, distinct=distinct), None if distinct else ms._add_shift(group)
            hf.reset_launches()
            res, flag = ms.combination_phase(group, buckets, sched, addx, add_shift)
            torch.cuda.synchronize()
            launches = {k: v for k, v in hf.launches.items() if v}
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                ms.combination_phase(group, buckets, sched, addx, add_shift)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            flagged = 0
            if bool(flag):
                counted = []

                def counting(p, q, addx=addx, counted=counted):
                    o, e = addx(p, q)
                    counted.append(int((e != 0).sum()))
                    return o, e

                ms.combination_phase(group, buckets, sched, counting)
                flagged = sum(counted)
                log(f"[combine] {group} {adder}: the flag fired on {flagged} lanes; "
                    f"taking the complete adder's result")
                res = r["complete"]["res"]
            if from_dev(res)[0] != want:
                fail(f"{group} combination phase through the {adder} adder does not match native_bridge.msm")
            r[adder] = dict(res=res, ms=sorted(times)[1] * 1e3, flag=bool(flag), flagged_lanes=flagged,
                            launches=launches)
            log(f"[{'combine' if mode == 'loop' else 'modes'}] {group} {n} points w={MSM_W}, {adder} adder"
                f"{'' if mode == 'loop' else f' in {mode}'}: {r[adder]['ms']:.2f} ms, "
                f"flag {'set' if flag else 'clear'}; launches {launches}; matches native")
        out[group] = {k: {kk: vv for kk, vv in v.items() if kk != "res"} for k, v in r.items()}
        missing = [hf.instance(k, mode) for k in COMBINE_KERNELS
                   if k.startswith(group) and not r["addx"]["launches"].get(hf.instance(k, mode))]
        if missing:
            fail(f"kernels of the {group} combination phase never launched: {missing}")
        other = sorted({k for v in r.values() for k in v["launches"] if hf.mode_of(k) != mode})
        if other:
            fail(f"the {group} combination phase in {mode} launched other modes' instances: {other}")
    return out


# ---------------------------------------------------------------------------
# Phase 4b: the multiply probes
# ---------------------------------------------------------------------------


def run_probes(gpu: str) -> dict:
    """K9, K1 by mode, K7, K8, K10, with the launch counts of every probe
    kernel set to 0 just before and read just after."""
    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.ops import hopper_field as hf

    hf.reset_launches()
    micro.reset_launches()
    t0 = time.perf_counter()
    res = micro.run_all("cuda")
    secs = time.perf_counter() - t0
    launches = dict(micro.launches)
    launches.update({k: hf.launches[k] for k in K1_MODE_KERNELS})
    for line in micro.report_lines(res, gpu):
        log(line)
    log(f"[probes] {secs:.1f} s; launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"probe kernels that never launched: {missing}")
    return dict(res=res, launches=launches)


# ---------------------------------------------------------------------------
# Phase 5: admin key generation on the card
# ---------------------------------------------------------------------------


def host_keys(depth: int):
    """CRS + SAVER keys for `depth` (blobs) through the host-native setup
    from FrRandom(SEED), cached under .torch_cache/ by depth and seed:
    (keys, the setup's seconds or None when cached)."""
    from vote_saver_tpu_torch.circuit.voting import build_voting_circuit
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    build_voting_circuit(depth, EID_BITS)  # cached: no setup time below includes it
    cache = ROOT / ".torch_cache" / f"keys_d{depth}_s{SEED:x}.pkl"
    if cache.exists():
        log(f"[setup] depth {depth}: cached {cache.relative_to(ROOT)}")
        return pickle.loads(cache.read_bytes()), None
    t0 = time.perf_counter()
    keys = phases.init_admin_phase_generate_keys(depth, EID_BITS, FrRandom(SEED), device="host")
    setup_s = time.perf_counter() - t0
    cache.parent.mkdir(exist_ok=True)
    cache.write_bytes(pickle.dumps(keys))
    log(f"[setup] depth {depth}: host-native setup {setup_s:.2f} s (keys)")
    return keys, setup_s


def election(depth: int):
    """Voter keys, the host-native keys (``host_keys``) and election data
    for `depth` (blobs), cached under .torch_cache/ by depth and seed;
    ``setup_s`` is the host-native setup's seconds, None when cached."""
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    cache = ROOT / ".torch_cache" / f"election_d{depth}_s{SEED:x}.pkl"
    if cache.exists():
        log(f"[setup] depth {depth}: cached {cache.relative_to(ROOT)}")
        return dict(pickle.loads(cache.read_bytes()), setup_s=None)
    keys, setup_s = host_keys(depth)
    rng = FrRandom(SEED + 2)
    voters = [phases.init_voter_phase(i, rng) for i in range(BATCH)]
    data = phases.init_admin_phase_generate_data(depth, EID_BITS, [v[0] for v in voters], rng)
    e = dict(voters=voters, keys=keys, data=data)
    cache.write_bytes(pickle.dumps(e))
    log(f"[setup] depth {depth}: election built")
    return dict(e, setup_s=setup_s)


def check_setup(e: dict, mode: str = "loop", depth: int = DEPTH, tag: str | None = None) -> dict:
    """The same keys through Groth16 setup for `depth` on the card, in the
    process's multiplier mode, which is `mode`: only its instances may
    launch.  At DEPTH in loop mode once more under the profiler."""
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    hf.reset_launches()
    t0 = time.perf_counter()
    keys = phases.init_admin_phase_generate_keys(depth, EID_BITS, FrRandom(SEED), device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(hf.launches)
    widths = {k: dict(hf.widths[hf.instance(k, mode)]) for k in ("g1_window_sum", "g2_window_sum")}
    names = ("pk_crs", "vk_crs", "pk_eid", "sk_eid", "vk_eid")
    differ = [n for n, a, b in zip(names, keys, e["keys"]) if a != b]
    host = "cached" if e["setup_s"] is None else f"{e['setup_s']:.2f} s"
    tag = tag or ("[setup]" if mode == "loop" else f"[modes] {mode}: setup")
    log(f"{tag} depth {depth} on the card: {secs:.2f} s (host-native arm: {host}); "
        f"launches {({k: v for k, v in launches.items() if v})}")
    if differ:
        fail(f"setup on the card in {mode} wrote other blobs than the host-native arm: {differ}")
    log(f"{tag}: the five blobs are byte-identical to the host-native arm's ({sum(map(len, keys))} bytes)")
    missing = [hf.instance(k, mode) for k in SETUP_KERNELS if launches[hf.instance(k, mode)] == 0]
    if missing:
        fail(f"kernels of the setup path never launched: {missing}")
    other = sorted(k for k, v in launches.items() if v and hf.mode_of(k) != mode)
    if other:
        fail(f"setup in {mode} launched other modes' instances: {other}")
    stray = {hf.instance(k, mode): launches[hf.instance(k, mode)] for k in OFF_SETUP_PATH
             if launches[hf.instance(k, mode)]}
    if stray:
        fail(f"setup in {mode} launched K3d's single distinct add: {stray}")
    log(f"{tag}: window sums by outputs {widths}, mont_inv_fq launches {launches[hf.instance('mont_inv_fq', mode)]}")
    out = dict(device_s=secs, host_s=e["setup_s"], launches=launches, widths=widths)
    if mode == "loop" and depth == DEPTH:
        # once more in a profiling window: the device time of each window sum and of the whole setup
        _keys, events = profile_window(
            lambda: phases.init_admin_phase_generate_keys(DEPTH, EID_BITS, FrRandom(SEED), device="cuda"))
        if events is None:
            log(f"{tag}: window sums' device time not measured (the profiling window lost records)")
        else:
            by = {k: sum(us for name, us in events if kernel_key(name) == k) / 1e3
                  for k in ("g1_window_sum", "g2_window_sum", "mont_inv_fq")}
            out["device_ms"] = dict(by, all=sum(us for _n, us in events) / 1e3)
            log(f"{tag}: device ms under torch.profiler: "
                + ", ".join(f"{k} {v:.4f}" for k, v in out["device_ms"].items()))
    return out


# ---------------------------------------------------------------------------
# Phase 5b: the int8 matmul NTT against the radix-2 path
# ---------------------------------------------------------------------------


def check_ntt(gpu: str) -> tuple[dict, set]:
    """Each kind of the matmul NTT at NTT_B x NTT_N, and at NTT_WIDE_B x
    NTT_WIDE_N, against the radix-2 path on the same inputs (random
    elements, the first row led by values that saturate digit columns and
    fold boundaries): exact equality, both timed a call; then each int8 product at the path's shapes timed alone
    with CUDA events and by the profiler, against the larger of its int8
    operations over INT8_OPS and its bytes (operands read once, the int32
    result written once) over HBM_BPS; one fold and one whole transform
    under the profiler (launches, and the products' share).  Returns the
    rows and the names of the product's device kernels."""
    import torch

    from vote_saver_tpu_torch.micro import random_limbs, time_ms
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.ops import ntt as tntt
    from vote_saver_tpu_torch.ops import ntt_mxu
    from vote_saver_tpu_torch.params import R

    dev = lb.device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def inputs(n, rows):
        x = random_limbs("fr", rows * n, dev, gen).reshape(rows, n, 8)
        x[0, :8] = lb.ints_to_tensor([0, 1, R - 1, R - 2, (1 << 254) - 1, R - (1 << 200), 2, R // 2], lb.FR, dev)
        x[1, :4] = lb.ints_to_tensor([R - 1] * 4, lb.FR, dev)
        return x

    def kinds(x) -> dict:
        """Each kind at x's shape against radix-2, both timed; the plans' host precompute timed first."""
        rows, n = x.shape[:2]
        t0 = time.perf_counter()
        mm = tntt.get_ntt(n, "matmul")
        for kind, _ref in NTT_KINDS:
            ntt_mxu.get_plan(n, kind)
        plans_s = time.perf_counter() - t0
        r2 = tntt.get_ntt(n, "radix2")
        res = dict(n=n, batch=rows, plans_host_s=plans_s, kinds={})
        for kind, ref in NTT_KINDS:
            ntt_mxu.reset_products()
            hf.reset_launches()
            t0 = time.perf_counter()
            got = getattr(mm, ref)(x)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            prods, k1 = dict(ntt_mxu.products), hf.launches["mont_mul_fr"]
            want = getattr(r2, ref)(x)
            equal = torch.equal(got, want)
            row = dict(equal=equal, max_abs_err=_diff((got,), (want,)), products=prods, k1_launches=k1,
                       first_call_s=first_s, matmul_ms=time_ms(lambda: getattr(mm, ref)(x), 5),
                       radix2_ms=time_ms(lambda: getattr(r2, ref)(x), 2))
            res["kinds"][kind] = row
            log(f"[ntt] {kind} n=2^{n.bit_length() - 1} x {rows}: equal={equal} max_abs_err={row['max_abs_err']} "
                f"matmul {row['matmul_ms']:.3f} ms a call (first call with the constants' upload "
                f"{1e3 * first_s:.1f} ms), radix-2 {row['radix2_ms']:.3f} ms; int8 products {prods}, K1 Fr "
                f"launches {k1}; {gpu}")
            if not equal:
                fail(f"the matmul NTT's {kind} at n = {n} x {rows} disagrees with the radix-2 path")
            del got, want
        log(f"[ntt] host precompute of the four plans at n=2^{n.bit_length() - 1}: {plans_s:.2f} s")
        return res

    x = inputs(NTT_N, NTT_B)
    out = kinds(x)
    # depth 14's domain (BASELINE config 4) at its batch, each kind exact against radix-2
    out["wide"] = kinds(inputs(NTT_WIDE_N, NTT_WIDE_B))
    torch.cuda.empty_cache()
    # each int8 product at the path's shapes, on the operands the path gives it
    plan = ntt_mxu.get_plan(NTT_N, "inv")
    n1, n2 = plan.n1, plan.n2
    xa = x.reshape(NTT_B, n1, n2, 8).transpose(1, 2).reshape(NTT_B * n2, n1, 8)
    xc = x.reshape(NTT_B, n1, n2, 8).reshape(NTT_B * n1, n2, 8)
    cols = ntt_mxu._columns(plan.table("c", dev), xc, "int8", "step_c")
    fold = ntt_mxu._consts("fold", dev)
    pieces = torch.randint(0, 128, (cols.shape[0] * cols.shape[1], fold.shape[0]), dtype=torch.int8, device=dev,
                           generator=gen)
    cases = {
        "step_a": (ntt_mxu._digits7_device(xa).reshape(NTT_B * n2, n1 * 37), plan.table("a", dev), 1),
        "step_c": (ntt_mxu._digits7_device(xc).reshape(NTT_B * n1, n2 * 37), plan.table("c", dev), 1),
        "fold": (pieces, fold, 2),
    }
    names: set = set()
    prods = {}
    for step, (a, b, per) in cases.items():
        a = torch.nn.functional.pad(a, (0, b.shape[0] - a.shape[1]))
        fn = lambda a=a, b=b: torch._int_mm(a, b)  # noqa: E731
        events = [(n, us) for n, us in profile_window(fn, warm=True)[1] or () if not n.startswith(("Memset", "Memcpy"))]
        names |= {n for n, _us in events}
        M, K, N = a.shape[0], b.shape[0], b.shape[1]
        ops, nbytes = 2 * M * K * N, M * K + K * N + 4 * M * N
        bound_ms = max(ops / INT8_OPS, nbytes / HBM_BPS) * 1e3
        # the constant operand is column-major (ntt_mxu._toeplitz_t_host); its row-major copy beside it
        b_rows = b.contiguous()
        row = dict(shape=[M, K, N], per_transform=per, ms=time_ms(fn, 10),
                   device_ms=sum(us for _n, us in events) / 1e3 if events else None, kernels=len(events),
                   bound_ms=bound_ms,
                   bound_by="operations" if ops / INT8_OPS >= nbytes / HBM_BPS else "bytes",
                   row_major_ms=time_ms(lambda a=a, b=b_rows: torch._int_mm(a, b), 3))
        prods[step] = row
        del b_rows
        log(f"[ntt] _int_mm {step} ({M} x {K} x {N} int8, {per} a transform): {row['ms']:.4f} ms a call, device "
            f"{_ms(row['device_ms'])} in {len(events)} kernel(s) seen by the profiler, bound {bound_ms:.4f} ms "
            f"({row['bound_by']}, {100 * bound_ms / row['ms']:.1f}%); the constant row-major {row['row_major_ms']:.4f} "
            f"ms; {gpu}")
    # a batch's products from the event-timed calls (the profiler may see no cuBLASLt kernel)
    per_batch = NTT_PER_BATCH * sum(r["per_transform"] * r["ms"] for r in prods.values())
    bound_ac = NTT_PER_BATCH * sum(prods[s]["bound_ms"] for s in ("step_a", "step_c"))
    bound_all = NTT_PER_BATCH * sum(r["per_transform"] * r["bound_ms"] for r in prods.values())
    log(f"[ntt] _int_mm ms a batch ({NTT_PER_BATCH} transforms, event-timed calls): {per_batch:.3f} ms against a "
        f"bound of {bound_ac:.3f} ms (steps A and C) / {bound_all:.3f} ms (with the folds); profiler kernel names "
        f"{sorted(names)}")
    fold_ev = profile_window(lambda: ntt_mxu._fold_mod_r(cols), warm=True)[1] or []
    tr_ev = profile_window(lambda: tntt.get_ntt(NTT_N, "matmul").intt(x), warm=True)[1] or []
    tr_lib = sum(us for n, us in tr_ev if n in names) / 1e3
    tr_k1 = sum(us for n, us in tr_ev if kernel_key(n)) / 1e3
    tr_all = sum(us for _n, us in tr_ev) / 1e3
    fold_ms = time_ms(lambda: ntt_mxu._fold_mod_r(cols), 5)
    log(f"[ntt] one fold at step C's shape ({cols.shape[0] * cols.shape[1]} rows): {fold_ms:.3f} ms a call; "
        f"{len(fold_ev)} device launches seen by the profiler, {sum(us for _n, us in fold_ev) / 1e3:.3f} ms on the "
        f"device")
    log(f"[ntt] one inverse transform: {len(tr_ev)} device launches seen by the profiler, {tr_all:.3f} ms on the "
        f"device: _int_mm {tr_lib:.3f} ms, K1 {tr_k1:.3f} ms, the rest {tr_all - tr_lib - tr_k1:.3f} ms")
    out.update(products=prods, int_mm_ms_per_batch=per_batch, bound_ms_per_batch=bound_ac,
               bound_ms_per_batch_with_folds=bound_all, fold_launches=len(fold_ev), fold_ms=fold_ms,
               transform=dict(launches=len(tr_ev), device_ms=tr_all, int_mm_ms=tr_lib, k1_ms=tr_k1))
    del x, cols, pieces, cases
    torch.cuda.empty_cache()
    return out, names


# ---------------------------------------------------------------------------
# Phases 6-7: the vote phase
# ---------------------------------------------------------------------------


def check_golden(tag: str = "[golden]") -> None:
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    golden = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    e = pickle.loads((ROOT / golden["source"]).read_bytes())
    ctx = phases.prepare_vote_context(
        golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"], e["pk_eid"],
        e["pk_crs"], e["vk_crs"], device="cuda",
    )
    expect = [[g[k] for k in ("proof", "pinput", "ct", "sn")] for g in golden["ballots"]]
    for arm, host_witness in (("device", False), ("host-witness", True)):
        t0 = time.perf_counter()
        ballots = phases.vote_with_context(
            ctx, golden["voters"], golden["votes"], [e["voters"][i][1] for i in golden["voters"]],
            FrRandom(golden["seed"]), host_witness=host_witness,
        )
        if [[x.hex() for x in b] for b in ballots] != expect:
            fail(f"depth-2 ballots of the {arm} arm differ from tests/golden/torch_slice_d2.json")
        log(f"{tag} {arm} arm: depth-2 ballots for voters {golden['voters']} byte-identical to the "
            f"JAX golden ({time.perf_counter() - t0:.1f} s)")


def kernel_key(name: str) -> str | None:
    """The port's kernel instance name (``hopper_field.KERNELS``) of a
    device kernel as the profiler names it (``(anonymous
    namespace)::k_double<Fq2, MulLoop>(...)``) or as ``_build.short_name``
    shortens ptxas's name, None for a kernel that is not in hopper_field:
    the loop name, with ``_v1`` / ``_fold`` for an instance in MulV1 /
    MulFold (``Called<MulV1>`` too); the G2 complete add's team kernel
    ``k_add_team<AddTeamG2,M>`` is ``g2_add``."""
    m = re.search(r"\bk_(mont_mul_mode|mont_mul|mont_inv|madd_scan|madd|add_distinct|addx|add_shift|add_team|add|double|"
                  r"window_sum)<([^,>]+)", name)
    if not m:
        return None
    fam, arg = m.groups()
    mode = "_v1" if "MulV1" in name else "_fold" if "MulFold" in name else ""
    if fam == "add_team":
        return "g2_add" + mode
    if fam.startswith("mont_"):
        return f"{fam[:8]}_{'fq' if 'FqParams' in arg else 'fr'}{mode}"
    return f"{'g2' if 'Fq2' in arg else 'g1'}_{fam}{mode}"


def instance_name(short: str) -> str | None:
    """The kernels-line name of a kernel in ptxas's report (shortened by
    ``_build.short_name``): hopper_field's through kernel_key, the probes'
    (``k_mul_chain<P,M,CHAINS,UNROLL,START>``, ``k_mul_chain_ptx<...>``,
    the tensor-core fold's ``k_mul_chain_mma<P,CHAINS,UNROLL>``:
    ``micro.instance``; ``k_op<KIND,CHAINS>``) from micro's tables; None
    for a device function."""
    from vote_saver_tpu_torch import micro

    key = kernel_key(short)
    if key is not None:
        return key
    probes = {micro.instance(k): f"mul_chain_{k}" for k in micro.CHAIN_PROBES}
    if short in probes:
        return probes[short]
    m = re.match(r"k_op<(.*)>$", short)
    if not m:
        return None
    args = m.group(1).split(",")
    return f"op_{list(micro.OP_KINDS)[int(args[0])]}" + ("_x8" if args[1] == "8" else "")


def sass_counts(text: str) -> dict:
    """``cuobjdump -sass`` output -> {kernels-line name: {"IMMA": n, "IDP":
    n, "FFMA": n, "all": n}} per kernel of the port: the instructions of
    each kind, and of every kind, in the kernel's code.  cuobjdump lists a
    device function that a kernel calls out of line (``Called<M>``'s
    multiply) inside that kernel's code, behind its ``CALL.REL.NOINC``
    target address, so its instructions count with the kernel's."""
    from vote_saver_tpu_torch.ops import _build

    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = instance_name(_build.short_name(m.group(1)))
            if name:
                out.setdefault(name, Counter(IMMA=0, IDP=0, FFMA=0, all=0))
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and op:
            out[name].update(["all"] + [op.group(1)] * (op.group(1) in ("IMMA", "IDP", "FFMA")))
    return {k: dict(v) for k, v in out.items()}


def check_fold_sass(gpu: str) -> dict:
    """The fold products on the tensor cores: ``cuobjdump -sass`` of the
    built probe and curve libraries (FOLD_UNITS) must show IMMA instructions
    and no IDP (dp4a) in each of FOLD_PROBES and hopper_field.MMA_KERNELS.
    The loop and v1 chain probes' instructions a multiply by class
    (``micro.sass_mix``: the carry chains beside the yardstick) are logged
    and returned with them."""
    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.ops import _build
    from vote_saver_tpu_torch.ops import hopper_field as hf

    counts = {}
    for unit in FOLD_UNITS:
        text = _build.sass(unit)
        counts.update(sass_counts(text))
        if unit == "micro.cu":
            mix = micro.sass_mix(text)
            for line in micro.sass_lines(mix, gpu):
                log(line)
    kernels = FOLD_PROBES + hf.MMA_KERNELS
    for k in kernels:
        c = counts.get(k)
        log(f"[sass] {k}: {c}")
        if not c or not c["IMMA"] or c["IDP"]:
            fail(f"{k} is not on the tensor cores (cuobjdump -sass: {c})")
    for k in DP4A_KERNELS:
        c = counts.get(k)
        log(f"[sass] {k}: {c}")
        if not c or c["IMMA"] or not c["IDP"]:
            fail(f"{k} is not the per-lane dp4a fold (cuobjdump -sass: {c})")
    return {**{k: counts[k] for k in (*kernels, *DP4A_KERNELS)}, **{f"mul_chain_{k}": v for k, v in mix.items()}}


def profile_batch(batch, library: set):
    """One device-arm batch in a profiling window (profile_window) ->
    (the batch's result, its profile): launches and device seconds per
    kernel of the port, those of the library calls whose device kernels
    are named in `library` (the NTT's int8 products), the plain PyTorch
    kernels' device seconds (the five largest by name), and the device's
    busy share of the batch's wall time under the profiler; the profile is
    empty where the window lost records or recorded no device kernel."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, events = profile_window(batch)
    wall = time.perf_counter() - t0
    ours: dict = {}
    lib = [0, 0.0]
    other: dict = {}
    for name, us in events or ():
        key = kernel_key(name)
        if name in library:
            lib[0] += 1
            lib[1] += us
        elif key is None:
            other[name] = other.get(name, 0.0) + us
        else:
            n, t = ours.get(key, (0, 0.0))
            ours[key] = (n + 1, t + us)
    if not ours and not other:
        return result, {}
    busy = sum(t for _n, t in ours.values()) + lib[1] + sum(other.values())
    return result, dict(wall_s=wall, busy_s=busy / 1e6, port={k: dict(launches=n, device_s=t / 1e6) for k, (n, t) in ours.items()},
                library=dict(launches=lib[0], device_s=lib[1] / 1e6), plain_s=sum(other.values()) / 1e6,
                top_plain={k: v / 1e6 for k, v in sorted(other.items(), key=lambda kv: -kv[1])[:5]})


def _plan_bytes() -> int:
    """Bytes of the matmul NTT's constants on the card (every plan built)."""
    from vote_saver_tpu_torch.ops import ntt_mxu

    plans = [ntt_mxu.get_plan(NTT_N, kind) for kind, _ref in NTT_KINDS]
    return sum(t.numel() * t.element_size() for p in plans for (_n, d), t in p._dev.items() if d.startswith("cuda"))


def _stages(timer, n: int) -> str:
    return ", ".join(f"{k} {v / n:.3f}" for k, v in timer.seconds.items())


def run_slice(rnd, e: dict, library: set) -> dict:
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import ntt_mxu
    from vote_saver_tpu_torch.protocol import groth16, phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    pk_crs, vk_crs, pk_eid, _sk_eid, vk_eid = e["keys"]
    eid, rt, tree = e["data"]
    t0 = time.perf_counter()
    ctx = phases.prepare_vote_context(DEPTH, EID_BITS, tree, rt, eid, pk_eid, pk_crs, vk_crs, device="cuda")
    log(f"[slice] context parsed in {time.perf_counter() - t0:.1f} s: {ctx.circ.cs.num_constraints} "
        f"constraints, {ctx.pk.num_vars} vars, domain {ctx.pk.domain}")
    idx = list(range(BATCH))
    sks = [v[1] for v in e["voters"]]
    rng = FrRandom(SEED + 1)

    def batch(timer=None, host_witness=False, ntt=None):
        votes = [rnd.randrange(25) for _ in idx]
        return votes, phases.vote_with_context(ctx, idx, votes, sks, rng, timer=timer, host_witness=host_witness,
                                               ntt=ntt)

    t0 = time.perf_counter()
    warm = [batch()]
    torch.cuda.synchronize()
    log(f"[slice] device arm warm-up batch (B={BATCH}): {time.perf_counter() - t0:.2f} s")
    hf.reset_launches()
    ntt_mxu.reset_products()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    timer = groth16.StageTimer("cuda")
    t0 = time.perf_counter()
    timed = [batch(timer), batch(timer)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hf.launches)
    products = dict(ntt_mxu.products)
    peak = torch.cuda.max_memory_allocated()

    hf.reset_launches()
    host_timer = groth16.StageTimer("cuda")
    t0 = time.perf_counter()
    host = [batch(host_timer, host_witness=True)]
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    host_launches = dict(hf.launches)

    # the device arm on the radix-2 NTT, the path of every batch before the matmul NTT
    hf.reset_launches()
    ntt_mxu.reset_products()
    torch.cuda.reset_peak_memory_stats()
    r2_held = torch.cuda.memory_allocated()
    r2_timer = groth16.StageTimer("cuda")
    t0 = time.perf_counter()
    radix2 = [batch(r2_timer, ntt="radix2")]
    torch.cuda.synchronize()
    r2_wall = time.perf_counter() - t0
    r2_launches, r2_products = dict(hf.launches), dict(ntt_mxu.products)
    r2_peak = torch.cuda.max_memory_allocated()

    hf.reset_launches()
    profiled, prof = profile_batch(batch, library)
    if prof:
        prof["widths"] = {k: dict(sorted(hf.widths[k].items())) for k in WIDTH_KERNELS}

    n_ok = verified([b for _votes, ballots in warm + timed + [profiled] + host + radix2 for b in ballots],
                    vk_eid, vk_crs)
    n_total = BATCH * (len(warm) + len(timed) + 1 + len(host) + len(radix2))
    out = dict(
        depth=DEPTH, batch=BATCH, proofs_per_s=BATCH * len(timed) / wall, batch_s=wall / len(timed),
        stages_s={k: v / len(timed) for k, v in timer.seconds.items()},
        stage_launches={k: v / len(timed) for k, v in timer.launches.items()},
        fallbacks=timer.counts.get("fallbacks", 0), launches=launches,
        int8_products={k: v / len(timed) for k, v in products.items()}, peak_bytes=peak, held_bytes=held,
        plan_bytes=_plan_bytes(),
        host_arm_batch_s=host_wall, host_arm_stages_s=dict(host_timer.seconds),
        radix2_batch_s=r2_wall, radix2_stages_s=dict(r2_timer.seconds), radix2_stage_launches=dict(r2_timer.launches),
        radix2_peak_bytes=r2_peak, radix2_held_bytes=r2_held, ballots_verified=n_ok, ballots_total=n_total, profile=prof,
        device_batches=warm + timed, ctx=ctx,
    )
    log(f"[slice] device arm, depth {DEPTH}, B={BATCH}: {out['batch_s']:.3f} s/batch = "
        f"{out['proofs_per_s']:.3f} proofs/s; var-base fallbacks {out['fallbacks']}")
    log("[slice] device arm per-batch stage seconds: " + _stages(timer, len(timed)))
    log("[slice] device arm per-batch kernel launches by stage: "
        + ", ".join(f"{k} {v:.0f}" for k, v in out["stage_launches"].items()))
    log(f"[slice] device arm launches over the two timed batches: {launches}")
    log(f"[slice] device arm int8 products a batch (matmul NTT): {out['int8_products']}; peak device memory "
        f"{peak / 2**20:.1f} MiB over the two timed batches, {(peak - held) / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} MiB held before them (the matmul NTT's constants {out['plan_bytes'] / 2**20:.1f} MiB)")
    log(f"[slice] host-witness arm, same call: {host_wall:.3f} s/batch = {BATCH / host_wall:.3f} proofs/s; "
        f"var-base fallbacks {host_timer.counts.get('fallbacks', 0)}")
    log("[slice] host-witness arm stage seconds: " + _stages(host_timer, 1))
    log(f"[slice] host-witness arm launches: {host_launches}")
    log(f"[slice] device arm on the radix-2 NTT, same call: {r2_wall:.3f} s/batch; peak device memory "
        f"{r2_peak / 2**20:.1f} MiB, {(r2_peak - r2_held) / 2**20:.1f} MiB above the {r2_held / 2**20:.1f} MiB "
        f"held before it; int8 products {r2_products}")
    log("[slice] radix-2 NTT batch stage seconds: " + _stages(r2_timer, 1))
    log("[slice] radix-2 NTT batch kernel launches by stage: "
        + ", ".join(f"{k} {v}" for k, v in r2_timer.launches.items()))
    if prof:
        log(f"[profile] one device-arm batch under torch.profiler: {prof['wall_s']:.3f} s wall, device busy "
            f"{prof['busy_s']:.3f} s = {100 * prof['busy_s'] / prof['wall_s']:.1f}%; plain PyTorch kernels "
            f"{prof['plain_s']:.3f} s; library calls (the NTT's _int_mm) "
            + (f"{1e3 * prof['library']['device_s']:.3f} ms in {prof['library']['launches']} launches"
               if prof["library"]["launches"] else "not measured (the profiler recorded none of their kernels)"))
        for k, v in sorted(prof["port"].items(), key=lambda kv: -kv[1]["device_s"]):
            log(f"[profile] {k}: {v['launches']} launches, {1e3 * v['device_s']:.3f} ms on the device, "
                f"{1e6 * v['device_s'] / v['launches']:.2f} us a launch")
        for k in WIDTH_KERNELS:
            v = prof["port"].get(k, dict(launches=0, device_s=0.0))
            log(f"[profile] {k} a batch: {v['launches']} launches, {1e3 * v['device_s']:.3f} ms on the device; "
                f"launches by width (lanes: launches) {prof['widths'][k]}")
        for k, v in prof["top_plain"].items():
            log(f"[profile] plain: {1e3 * v:.3f} ms {k[:120]}")
    else:
        log("[profile] device time per kernel on the vote path: not measured (the profiler recorded no device kernel)")
    log(f"[slice] ballots verified: {n_ok}/{n_total} (device arm {BATCH * 4}, host-witness arm {BATCH}, "
        f"radix-2 NTT {BATCH})")
    if n_ok != n_total:
        fail("a depth-6 ballot failed verify_ballot")
    if products != {"step_a": 2 * NTT_PER_BATCH, "step_c": 2 * NTT_PER_BATCH, "fold": 4 * NTT_PER_BATCH} or any(
            r2_products.values()):
        fail(f"the vote path's NTTs did not run as chosen: matmul {products}, radix-2 {r2_products}")
    for arm, counts, kernels in (("device", launches, VOTE_KERNELS), ("host-witness", host_launches, HOST_ARM_KERNELS)):
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"kernels of the {arm} vote arm never launched: {missing}")
        stray = {k: counts[k] for k in OFF_VOTE_PATH if counts[k]}
        if stray or (prof and any(k in prof["port"] for k in OFF_VOTE_PATH)):
            fail(f"the {arm} vote arm launched K2's single-row form: {stray}")
    return out


def check_path_kernels(vote: dict, dev="cuda") -> dict:
    """K3 in G2 and G1 and K1 in Fr at the vote path's own shapes, each
    against its plain version on the same inputs: the complete adds (G2: a
    team of threads a lane; G1 fold: a block's four warps sharing a 32-lane
    add), in every multiplier mode, at ADD_WIDTHS and the widest launch of
    [profile]'s batch (its largest orphan merge), G2 on
    testing.team_add_lanes' special lanes, G1 on testing.special_lanes'
    (the doubling corner in the first 32 lanes only, as the path's adds
    rarely meet it), and K1 in Fr at the depth-6 B =
    16 batch's large calls with their real tables: the three COO products
    (the coefficient table read in place), the R1CS check, H times the
    constant zh_coset_inv (from_mont's shape too) and the matmul NTT's
    twiddle.  Each row: equality, the
    event-timed ms a call, the profiler's device ms a launch, the plain ms
    and the work the bound counts (a broadcast table's lanes once)."""
    import torch

    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.micro import time_ms
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.ops import ntt, ntt_mxu
    from vote_saver_tpu_torch.protocol import groth16
    from vote_saver_tpu_torch.testing import special_lanes, team_add_lanes

    dev = torch.device(dev)
    rnd = random.Random(SEED + 10)
    out = {"mont_mul_fr": []}
    for kname, base in ADD_WIDTHS.items():
        g2 = kname.startswith("g2")
        hist = (vote["profile"] or {}).get("widths", {}).get(kname, {})
        for lanes in sorted(set(base) | ({max(hist)} if hist else set())):
            if g2:
                p, q = team_add_lanes(True, lanes, rnd)
            else:
                p, q, *_ = special_lanes(False, max(lanes, 8), rnd)
                p, q = p[:lanes], q[:lanes]
            P, Qd = (_to_dev(zip(*pts), dev) for pts in (p, q))
            plain = lambda g2=g2, P=P, Qd=Qd: hf.add_plain(g2, P, Qd)  # noqa: E731
            exp = plain()
            plain_ms = time_ms(plain, 3)
            reps = 50 if lanes <= 1024 else 20
            add = hf.g2_add if g2 else hf.g1_add
            for mode in hf.MODES:
                inst = hf.instance(kname, mode)
                kern = lambda P=P, Qd=Qd, mode=mode, add=add: add(P, Qd, mode=mode)  # noqa: E731
                got = kern()
                torch.cuda.synchronize()
                work = mode_work(dict(bytes=_nbytes(*P, *Qd, *got), mads=_curve_mads("add", g2, _finite(P[2], Qd[2]))),
                                 mode)
                row = dict(shape=[lanes], lanes=lanes, equal=all(torch.equal(x, y) for x, y in zip(got, exp)),
                           max_abs_err=_diff(got, exp), ms=time_ms(kern, reps),
                           device_ms=device_ms(kern, reps, "k_add_team" if g2 else "k_add<"), plain_ms=plain_ms,
                           work=work)
                log(f"[{'kernels' if mode == 'loop' else 'modes'}] {inst}: {lanes} lanes equal={row['equal']} "
                    f"max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms a call, device "
                    f"{_ms(row['device_ms'])} a launch, plain {row['plain_ms']:.3f} ms")
                if not row["equal"]:
                    fail(f"{inst} at {lanes} lanes disagrees with its plain version")
                out.setdefault(inst, []).append(row)
    ctx = vote["ctx"]
    pk, B, n = ctx.pk, BATCH, ctx.pk.domain
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

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
        _x, _y, _shape, lanes, nb = hf.mul_operands(a, b)
        full = tuple(t.contiguous() for t in torch.broadcast_tensors(a, b))
        kern = lambda a=a, b=b: (hf.mont_mul("fr", a, b),)  # noqa: E731
        plain = lambda full=full: (hf.mont_mul_plain("fr", *full),)  # noqa: E731
        before = hf.launches["mont_mul_fr"]
        got, exp = kern(), plain()
        torch.cuda.synchronize()
        if hf.launches["mont_mul_fr"] != before + 1:
            fail(f"mont_mul_fr at {desc} did not launch once")
        row = dict(shape=[desc, lanes, nb], lanes=lanes, equal=torch.equal(got[0], exp[0]),
                   max_abs_err=_diff(got, exp), ms=time_ms(kern, 50), device_ms=device_ms(kern, 50, "k_mont_mul<"),
                   plain_ms=time_ms(plain, 3), work=dict(bytes=(2 * lanes + nb) * 4 * lb.FR.num_limbs,
                                                         mads=lanes * MADS["fr"]))
        log(f"[kernels] mont_mul_fr: {desc} {lanes} lanes, table {nb} lanes, equal={row['equal']} "
            f"max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms a call, device {_ms(row['device_ms'])} "
            f"a launch, plain {row['plain_ms']:.3f} ms")
        if not row["equal"]:
            fail(f"mont_mul_fr at {desc} disagrees with its plain version")
        out["mont_mul_fr"].append(row)
    return out


def run_modes(e: dict, vote: dict, cases, library: set) -> dict:
    """[modes]: the vote path, setup and the combination phase in each of
    CURVE_MODES, chosen as a user chooses it, by VSTPU_MUL (restored
    after).  Per mode: depth-6 setup on the card (check_setup: the host-
    native arm's blobs, only the mode's instances launched); [slice]'s
    device-arm batches 0-2 again from FrRandom(SEED + 1) with their votes,
    byte for byte: batch 0 the warm-up, batch 1 timed by stage, batch 2
    under torch.profiler (the device's busy share), the first two verified
    (batch 2 equals [slice]'s verified one); the depth-2 golden through both
    arms; the combination phase on [msm]'s buckets through both adders
    (check_combination).  Each path's launch counts are set to 0 just
    before it and read just after: every kernel of the path launched as the
    mode's instance, and no other mode's instance launched."""
    import os

    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import groth16, phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    _pk_crs, vk_crs, _pk_eid, _sk_eid, vk_eid = e["keys"]
    ctx, idx, sks = vote["ctx"], list(range(BATCH)), [v[1] for v in e["voters"]]
    loop = vote["device_batches"][:3]
    before = os.environ.get("VSTPU_MUL")
    out = {}

    def only(mode: str, counts: dict, kernels, what: str) -> None:
        missing = [hf.instance(k, mode) for k in kernels if counts[hf.instance(k, mode)] == 0]
        other = sorted(k for k, v in counts.items() if v and hf.mode_of(k) != mode)
        if missing or other:
            fail(f"{what} in {mode}: never launched {missing}, launched other modes' instances {other}")

    try:
        for mode in CURVE_MODES:
            os.environ["VSTPU_MUL"] = mode
            r = out[mode] = {}
            t0 = time.perf_counter()
            r["setup"] = check_setup(e, mode)
            rng = FrRandom(SEED + 1)
            ballots, prof = [], {}
            for k, (votes, _b) in enumerate(loop):
                hf.reset_launches()
                timer = groth16.StageTimer("cuda") if k == 1 else None
                t1 = time.perf_counter()
                if k == 2:
                    got, prof = profile_batch(lambda v=votes: phases.vote_with_context(ctx, idx, v, sks, rng), library)
                else:
                    got = phases.vote_with_context(ctx, idx, votes, sks, rng, timer=timer)
                torch.cuda.synchronize()
                if k == 1:
                    r.update(batch_s=time.perf_counter() - t1, stages_s=dict(timer.seconds),
                             stage_launches=dict(timer.launches), launches=dict(hf.launches))
                    only(mode, hf.launches, VOTE_KERNELS, "the device-arm batch")
                    stray = {k2: hf.launches[hf.instance(k2, mode)] for k2 in OFF_VOTE_PATH
                             if hf.launches[hf.instance(k2, mode)]}
                    if stray:
                        fail(f"the device-arm batch in {mode} launched K2's single-row form: {stray}")
                if [[x.hex() for x in b] for b in got] != [[x.hex() for x in b] for b in loop[k][1]]:
                    fail(f"depth-6 batch {k} in {mode} differs from the loop batch's ballots")
                ballots.append(got)
            r["profile"] = {k: prof.get(k) for k in ("wall_s", "busy_s", "plain_s", "port")} if prof else {}
            n_ok = verified([b for got in ballots[:2] for b in got], vk_eid, vk_crs)
            if n_ok != 2 * BATCH:
                fail(f"a depth-6 ballot in {mode} failed verify_ballot ({n_ok}/{2 * BATCH})")
            log(f"[modes] {mode}: depth-6 B={BATCH} device-arm batches 0-2 byte-identical to the loop mode's; "
                f"{n_ok}/{2 * BATCH} ballots of batches 0-1 verified (batch 2 equals [slice]'s verified one); "
                f"timed batch {r['batch_s']:.3f} s; stage seconds "
                + ", ".join(f"{k} {v:.3f}" for k, v in r["stages_s"].items()))
            log(f"[modes] {mode}: launches of the timed batch {({k: v for k, v in r['launches'].items() if v})}")
            if prof:
                log(f"[modes] {mode}: one batch under torch.profiler: {prof['wall_s']:.3f} s wall, device busy "
                    f"{prof['busy_s']:.3f} s = {100 * prof['busy_s'] / prof['wall_s']:.1f}%; plain PyTorch "
                    f"kernels {prof['plain_s']:.3f} s")
                for k, v in sorted(prof["port"].items(), key=lambda kv: -kv[1]["device_s"]):
                    log(f"[modes] {mode} profile {k}: {v['launches']} launches, {1e3 * v['device_s']:.3f} ms on "
                        f"the device")
            else:
                log(f"[modes] {mode}: device busy share not measured (the profiler recorded no device kernel)")
            hf.reset_launches()
            check_golden(f"[modes] {mode}: golden")
            only(mode, hf.launches, (), "the depth-2 golden")
            r["combine"] = check_combination(cases, mode)
            if mode == "fold":
                r["mma_info"] = {k: log_mma_info(k) for k in hf.MMA_KERNELS}
            r["seconds"] = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("VSTPU_MUL", None)
        else:
            os.environ["VSTPU_MUL"] = before
    return out


def _path_launches(kernels, what: str) -> dict:
    """The launches since the last reset; fails if a kernel of the path ran no time."""
    from vote_saver_tpu_torch.ops import hopper_field as hf

    counts = dict(hf.launches)
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        fail(f"kernels of {what} never launched: {missing}")
    return counts


def run_tally(e: dict, seq: list, gpu: str) -> dict:
    """[slice]'s first timed batch tallied: its 16 ciphertexts aggregated
    and decrypted by tally_admin_phase, the result checked by
    tally_voter_phase; host code, so no kernel of the port may launch."""
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import ntt_mxu
    from vote_saver_tpu_torch.params import MSG_SIZE
    from vote_saver_tpu_torch.protocol import marshal as M
    from vote_saver_tpu_torch.protocol import phases

    pk_crs, vk_crs, _pk_eid, sk_eid, vk_eid = e["keys"]
    votes, ballots = seq[1]
    cts = [b[2] for b in ballots]
    hf.reset_launches()
    ntt_mxu.reset_products()
    t0 = time.perf_counter()
    dec_proof, result = phases.tally_admin_phase(DEPTH, cts, sk_eid, vk_eid, pk_crs, vk_crs)
    admin_s = time.perf_counter() - t0
    counts = M.de_scalar_vector(result)
    want = [votes.count(c) for c in range(MSG_SIZE)]
    if counts != want:
        fail(f"the tally's counts {counts} are not the batch's votes {want}")
    t0 = time.perf_counter()
    ok = phases.tally_voter_phase(DEPTH, cts, vk_eid, pk_crs, vk_crs, result, dec_proof)
    voter_s = time.perf_counter() - t0
    forged = list(counts)
    top = max(range(MSG_SIZE), key=lambda c: counts[c])
    forged[top] -= 1
    forged[(top + 1) % MSG_SIZE] += 1
    rejected = not phases.tally_voter_phase(DEPTH, cts, vk_eid, pk_crs, vk_crs, M.ser_scalar_vector(forged),
                                            dec_proof)
    launched = {k: v for k, v in hf.launches.items() if v}
    log(f"[tally] {len(cts)} ballots of depth {DEPTH}: counts {counts} equal the batch's votes; tally_admin_phase "
        f"{admin_s:.3f} s, tally_voter_phase {voter_s:.3f} s (host); verified {ok}, forged result rejected "
        f"{rejected}; kernel launches {launched or 0}, int8 products {sum(ntt_mxu.products.values())}; {gpu}")
    if not ok or not rejected:
        fail("the tally did not verify, or a forged result passed")
    if launched or any(ntt_mxu.products.values()):
        fail("the tally (host code) launched device kernels")
    return dict(admin_s=admin_s, voter_s=voter_s)


def count_syncs(fn) -> Counter:
    """fn()'s synchronizing CUDA calls (torch.cuda.set_sync_debug_mode),
    counted by the line of the port that made each."""
    import torch

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return Counter(f"{pathlib.Path(w.filename).relative_to(ROOT) if w.filename.startswith(str(ROOT)) else w.filename}"
                   f":{w.lineno}" for w in rec if "synchroniz" in str(w.message))


def run_stream(e: dict, seq: list, rnd, library: set, gpu: str) -> dict:
    """[slice]'s device-arm batches (its seed, voters and votes) and
    STREAM_EXTRA more through vote_with_context_stream and through
    sequential vote_with_context calls, in turns; every pass byte-identical
    to [slice]'s ballots and to each other, with the same launches."""
    import numpy as np
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import limbs as lb
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    pk_crs, vk_crs, pk_eid, _sk_eid, vk_eid = e["keys"]
    eid, rt, tree = e["data"]
    ctx = phases.prepare_vote_context(DEPTH, EID_BITS, tree, rt, eid, pk_eid, pk_crs, vk_crs, device="cuda")
    idx = list(range(BATCH))
    sks = [v[1] for v in e["voters"]]
    votes = [v for v, _b in seq] + [[rnd.randrange(25) for _ in idx] for _ in range(STREAM_EXTRA)]
    batches = [(idx, v, sks) for v in votes]

    def sequential(bs=batches):
        rng = FrRandom(SEED + 1)
        return [phases.vote_with_context(ctx, *b, rng) for b in bs]

    def stream(bs=batches):
        return list(phases.vote_with_context_stream(ctx, bs, FrRandom(SEED + 1)))

    secs: dict = {"sequential": [], "stream": []}
    passes = []
    for name, fn in (("sequential", sequential), ("stream", stream), ("stream", stream), ("sequential", sequential)):
        hf.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs[name].append((time.perf_counter() - t0) / len(batches))
        passes.append((name, got, _path_launches(VOTE_KERNELS, f"the {name} vote pass")))
    expect = [b for _v, b in seq]
    for name, got, counts in passes:
        if got[: len(seq)] != expect or got != passes[0][1]:
            fail(f"a {name} pass's ballots differ from [slice]'s sequential ones")
        if counts != passes[0][2]:
            fail(f"a {name} pass launched {counts}, the sequential pass {passes[0][2]}")
    syncs = {name: count_syncs(lambda fn=fn: fn(batches[:SYNC_BATCHES])) for name, fn in
             (("sequential", sequential), ("stream", stream))}
    # what the pinned, non-blocking uploads save: the same count with a plain .to() of pageable memory
    upload = lb.upload
    lb.upload = lambda a, device: torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)
    try:
        syncs["sequential, blocking uploads"] = count_syncs(lambda: sequential(batches[:SYNC_BATCHES]))
    finally:
        lb.upload = upload
    profiled, prof = profile_batch(lambda: stream(batches[:3]), library)
    if profiled != expect[:3]:
        fail("the profiled stream pass's ballots differ from [slice]'s")
    # the first batches are [slice]'s, verified there
    n_ok = verified([b for bs in passes[0][1][len(seq):] for b in bs], vk_eid, vk_crs)
    per_batch = {k: v / len(batches) for k, v in passes[0][2].items() if v}
    log(f"[stream] {len(batches)} batches of B={BATCH} at depth {DEPTH}, byte-identical to [slice]'s sequential "
        f"ballots in every pass; pipelined {' / '.join(f'{x:.3f}' for x in secs['stream'])} s/batch against "
        f"sequential {' / '.join(f'{x:.3f}' for x in secs['sequential'])} s/batch, same call (turns: sequential, "
        f"stream, stream, sequential); {gpu}")
    log(f"[stream] kernel launches a batch, every pass: {sum(per_batch.values()):.0f} ({per_batch})")
    for name, c in syncs.items():
        log(f"[stream] {name}: {sum(c.values()) / SYNC_BATCHES:.1f} synchronizing CUDA calls a batch over "
            f"{SYNC_BATCHES} batches; by line: {dict(c.most_common())}")
    if prof:
        log(f"[stream] one stream pass of 3 batches under torch.profiler: {prof['wall_s']:.3f} s wall, device busy "
            f"{prof['busy_s']:.3f} s = {100 * prof['busy_s'] / prof['wall_s']:.1f}% (the NTT's _int_mm "
            + (f"{1e3 * prof['library']['device_s']:.3f} ms included)" if prof["library"]["launches"]
               else "not seen by the profiler)"))
    else:
        log("[stream] device busy share: not measured (the profiler recorded no device kernel)")
    log(f"[stream] ballots of the {STREAM_EXTRA} batches past [slice]'s verified: {n_ok}/{BATCH * STREAM_EXTRA}")
    if n_ok != BATCH * STREAM_EXTRA:
        fail("a stream ballot failed verify_ballot")
    return dict(stream_s=secs["stream"], sequential_s=secs["sequential"],
                syncs={k: sum(c.values()) / SYNC_BATCHES for k, c in syncs.items()}, profile=prof)


def run_api(e: dict, rnd, gpu: str) -> dict:
    """vote_phase_batch, blobs in and ballots out, twice from an empty parse
    cache: the first call parses the depth-6 keys, the second finds them
    (and the device constants cached on the proving key)."""
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.protocol import marshal as M
    from vote_saver_tpu_torch.protocol import phases
    from vote_saver_tpu_torch.utils.rng import FrRandom

    pk_crs, vk_crs, pk_eid, _sk_eid, vk_eid = e["keys"]
    eid, rt, tree = e["data"]
    idx = list(range(BATCH))
    sks = [v[1] for v in e["voters"]]
    parse_s: list = []
    prepare = phases.prepare_vote_context

    def timed_prepare(*args, **kwargs):
        t0 = time.perf_counter()
        ctx = prepare(*args, **kwargs)
        parse_s.append(time.perf_counter() - t0)
        return ctx

    M._DE_CACHE.clear()  # as in a fresh process
    phases.prepare_vote_context = timed_prepare
    calls = []
    try:
        for k in range(2):
            votes = [rnd.randrange(25) for _ in idx]
            hf.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ballots = phases.vote_phase_batch(DEPTH, EID_BITS, idx, votes, tree, rt, eid, sks, pk_eid, pk_crs,
                                              vk_crs, FrRandom(SEED + 4 + k))
            calls.append(time.perf_counter() - t0)
            _path_launches(VOTE_KERNELS, f"vote_phase_batch call {k + 1}")
            n_ok = verified(ballots, vk_eid, vk_crs)
            if n_ok != BATCH:
                fail(f"vote_phase_batch call {k + 1}: {n_ok}/{BATCH} ballots verified")
    finally:
        phases.prepare_vote_context = prepare
    log(f"[api] vote_phase_batch x2 (B={BATCH}, depth {DEPTH}) from an empty parse cache: parse {parse_s[0]:.3f} / "
        f"{parse_s[1]:.3f} s, call {calls[0]:.3f} / {calls[1]:.3f} s; {2 * BATCH}/{2 * BATCH} ballots verified; {gpu}")
    return dict(parse_s=parse_s, call_s=calls)


def _merkle_leaves(depth: int):
    """2^depth seeded 255-bit leaves: the first all ones, the last quarter
    all zeros (the keys an election pads its tree with)."""
    import numpy as np

    leaves = np.random.default_rng(SEED + depth).integers(0, 2, (1 << depth, 255)).astype(np.int32)
    leaves[0] = 1
    leaves[len(leaves) - len(leaves) // 4 :] = 0
    return leaves


def run_merkle(gpu: str) -> dict:
    """Merkle trees on the card (``merkle.build_tree``, one Pedersen call a
    level): at MERKLE_DEPTHS byte for byte against the oracle arm, both
    timed; at MERKLE_DEEP on the card only, with the root, MERKLE_SAMPLES
    seeded leaves and MERKLE_SAMPLES seeded parents recomputed by the oracle
    from the card's own children.  Seconds, hashes/s and peak device memory
    a depth; the launches of the Pedersen kernels over the phase."""
    import numpy as np
    import torch

    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import merkle
    from vote_saver_tpu_torch.ops import pedersen_ops as po
    from vote_saver_tpu_torch.protocol import marshal as M
    from vote_saver_tpu_torch.refimpl import pedersen as rpd

    def oracle(bits) -> np.ndarray:
        return np.array(rpd.pedersen_hash([int(b) for b in bits]), np.uint32)

    t0 = time.perf_counter()
    for w in (85, 170):
        po.window_tables(w, "cuda")
    torch.cuda.synchronize()
    log(f"[merkle] window tables (85 and 170 windows) on the card: {time.perf_counter() - t0:.2f} s (built from "
        f"the oracle at their first use, the election's tree when it is not cached)")
    hf.reset_launches()
    out = {}
    rnd = random.Random(SEED + MERKLE_DEEP)
    for depth in (*MERKLE_DEPTHS, MERKLE_DEEP):
        leaves = _merkle_leaves(depth)
        before = dict(hf.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        levels = merkle.build_tree(leaves, "cuda")  # digests come back to the host: the tree is done
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        hashes = (2 << depth) - 1
        row = dict(device_s=secs, hashes=hashes, hashes_per_s=hashes / secs, peak_bytes=peak,
                   launches={k: hf.launches[k] - before[k] for k in MERKLE_KERNELS})
        if depth in MERKLE_DEPTHS:
            t0 = time.perf_counter()
            host = merkle.build_tree(leaves, "host")
            row["host_s"] = time.perf_counter() - t0
            if M.ser_merkle_tree(merkle.flatten_tree(levels)) != M.ser_merkle_tree(merkle.flatten_tree(host)):
                fail(f"the depth-{depth} tree built on the card differs from the oracle's")
            check = f"byte-identical to the oracle's ({hashes * 32} bytes); oracle {row['host_s']:.2f} s = " \
                    f"{hashes / row['host_s']:.1f} hashes/s"
        else:
            n = 1 << depth
            bad = [i for i in rnd.sample(range(n), MERKLE_SAMPLES) if not np.array_equal(levels[0][i], oracle(leaves[i]))]
            parents = [(depth, 0)] + [(k, rnd.randrange(n >> k)) for k in
                                      (rnd.randrange(1, depth + 1) for _ in range(MERKLE_SAMPLES))]
            bad += [(k, j) for k, j in parents if not np.array_equal(
                levels[k][j], oracle(np.concatenate([levels[k - 1][2 * j], levels[k - 1][2 * j + 1]])))]
            if bad:
                fail(f"the depth-{depth} tree's digests differ from the oracle's at {bad[:8]}")
            check = f"the root, {MERKLE_SAMPLES} seeded leaves and {MERKLE_SAMPLES} seeded parents equal the oracle's"
        out[depth] = row
        log(f"[merkle] depth {depth} on the card: {secs:.3f} s = {row['hashes_per_s']:.1f} hashes/s "
            f"({hashes} hashes); peak device memory {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held; "
            f"launches {row['launches']}; {check}; {gpu}")
    return dict(depths=out, launches=_path_launches(MERKLE_KERNELS, "the Merkle build"))


def run_scale(gpu: str) -> dict:
    """[scale]: BASELINE config 4 (SCALE_CONFIGS) at its depth (14) and
    batch (B = 32), cut to SCALE_VOTERS voters, in loop mode.  At each depth:
    setup on the card byte for byte against the host-native arm (window
    sums, not K3d); then ``scale.run`` through the stream from an empty
    cache (setup and the Merkle tree on the card, the parse, two batches,
    SCALE_VERIFY verified, the tally and its check, the counts), its vote
    batches launching every vote kernel and no single-row madd, and H's
    seven transforms a batch on the matmul NTT at the depth's domain
    (SCALE_DOMAIN).  Returns each depth's record and its setup's row."""
    import shutil

    from vote_saver_tpu_torch import scale
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.ops import ntt_mxu

    transforms = Counter()
    apply = ntt_mxu.MatmulNTTPlan.apply

    def counted(plan, x, *a, **k):
        transforms[plan.n] += 1
        return apply(plan, x, *a, **k)

    cache, scale_cache = ROOT / ".torch_cache" / "smoke_scale", scale.CACHE
    shutil.rmtree(cache, ignore_errors=True)
    ntt_mxu.MatmulNTTPlan.apply, scale.CACHE = counted, cache
    out = {}
    try:
        for config in SCALE_CONFIGS:
            depth, B = scale.CONFIGS[config]["depth"], scale.CONFIGS[config]["batch"]
            tag = f"[scale] depth {depth}"
            keys, host_s = host_keys(depth)
            setup = check_setup(dict(keys=keys, setup_s=host_s), depth=depth, tag=f"{tag}: setup")
            hf.reset_launches()
            transforms.clear()
            try:
                rec = scale.run(config, SCALE_VOTERS, stream=True, verify_sample=SCALE_VERIFY, device="cuda")
            except RuntimeError as exc:
                fail(f"{tag}: {exc}")
            n_batches = -(-SCALE_VOTERS // B)
            vl = rec["vote_launches"]
            missing = [k for k in VOTE_KERNELS if not vl.get(k)]
            if missing:
                fail(f"{tag}: kernels of the vote path never launched: {missing}")
            stray = {k: vl[k] for k in OFF_VOTE_PATH if vl.get(k)}
            if stray:
                fail(f"{tag}: the vote path launched K2's single-row form: {stray}")
            if not all(hf.launches[k] for k in SETUP_KERNELS):
                fail(f"{tag}: the run's setup did not run on the card: {dict(hf.launches)}")
            want = {SCALE_DOMAIN[depth]: NTT_PER_BATCH * n_batches}
            if rec["domain"] != SCALE_DOMAIN[depth] or dict(transforms) != want:
                fail(f"{tag}: H's transforms by domain {dict(transforms)} (domain {rec['domain']}), not {want}")
            if (rec["verified"] != list(SCALE_VERIFY) or rec["tally_counts_ok"] is not True
                    or (rec["batch"], rec["voters"], rec["vote_mode"]) != (B, SCALE_VOTERS, "stream")):
                fail(f"{tag}: the record is not the run asked for: {rec}")
            t = rec["times_s"]
            first = t["vote_first_batch_incl_compile"]
            per_batch = {k: v / n_batches for k, v in vl.items()}
            log(f"{tag}: {gpu}; setup on the card {setup['device_s']:.3f} s, host-native "
                f"{'cached' if host_s is None else f'{host_s:.3f} s'}; window sums by outputs {setup['widths']}; "
                f"{SCALE_VOTERS} voters in {n_batches} stream batches of B = {B}: {t['vote_total']:.3f} s, "
                f"{t['vote_total'] / n_batches:.3f} s a batch (the first ballots after {first:.3f} s, the next "
                f"batch launched before their tail; the rest {t['vote_total'] - first:.3f} s); stages a batch (s) "
                f"{({k: round(v, 4) for k, v in rec['stage_s'].items()})}; "
                f"launches a batch {per_batch}; peak device memory {rec['peak_device_bytes'] / 2**30:.3f} GiB")
            log(f"{tag}: phases (s) {({k: round(v, 3) for k, v in t.items()})}; H: {want} transforms on the matmul "
                f"NTT; verified voters {rec['verified']}; the tally verifies and its counts equal the votes")
            out[depth] = dict(record=rec, setup=setup)
    finally:
        ntt_mxu.MatmulNTTPlan.apply, scale.CACHE = apply, scale_cache
    return out


def run_sharded(e: dict, vote: dict, gpu: str) -> dict:
    """[sharded]: ``entry.dryrun_multichip(4)`` on the one card (4 gloo
    ranks, points 2 x voters 2: the sharded NTT, NTT4, MSM, scheduled MSM,
    tally and a depth-2 ``vote_with_context(mesh=)``, each against its
    unsharded result) and, at the same time, ``vote_with_context(mesh=)``
    at DEPTH, B = BATCH on SHARDED_POINTS more gloo ranks of the card, sent
    [slice]'s parsed context: each rank's ballots byte for byte [slice]'s
    first device-arm batch under its seed (FrRandom(SEED + 1), its votes),
    SHARDED_VERIFY of them verified, every vote kernel launched on each
    rank and no single-row madd.  Per rank: seconds until its mesh was up,
    wall seconds and launches; the backend and the transport."""
    from vote_saver_tpu_torch import entry
    from vote_saver_tpu_torch.parallel import sharded

    _pk_crs, vk_crs, _pk_eid, _sk_eid, vk_eid = e["keys"]
    votes, want = vote["device_batches"][0]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        deep = pool.submit(sharded.spawn, entry.vote, (vote["ctx"].on("cuda"), list(range(BATCH)), votes,
                                                       [v[1] for v in e["voters"]], SEED + 1),
                           SHARDED_POINTS, 1, "cuda", "gloo")
        try:
            dry = entry.dryrun_multichip(4, "cuda")
        except RuntimeError as exc:
            fail(f"[sharded] dryrun_multichip(4): {exc}")
        try:
            ranks = deep.result()
        except RuntimeError as exc:
            fail(f"[sharded] depth {DEPTH}: {exc}")
    wall = time.perf_counter() - t0
    for i, r in enumerate(dry["ranks"]):
        missing = [k for k in B1_KERNELS if not r["launches"].get(k)]
        if missing:
            fail(f"[sharded] dryrun rank {i}: kernels of its vote never launched: {missing}")
    log(f"[sharded] dryrun_multichip(4): {', '.join(dry['checks'])} equal to their unsharded results on points="
        f"{dry['n_points']} x voters={dry['n_voters']}, backend {dry['backend']}, transport {dry['transport']}; "
        f"{dry['seconds']:.3f} s (by step: {({k: round(v, 3) for k, v in dry['steps'].items()})}, the unsharded "
        f"results made while the ranks run); by rank: up after {[round(r['ready_s'], 3) for r in dry['ranks']]} s "
        f"(start, imports, card, process group), then {[round(r['seconds'], 3) for r in dry['ranks']]} s; {gpu}")
    for i, r in enumerate(dry["ranks"]):
        log(f"[sharded] dryrun rank {i} launches: {r['launches']}")
    for i, r in enumerate(ranks):
        if r.value != want:
            fail(f"[sharded] depth {DEPTH}: rank {i}'s ballots differ from the unsharded batch's")
        missing = [k for k in VOTE_KERNELS if not r.launches.get(k)]
        stray = {k: r.launches[k] for k in OFF_VOTE_PATH if r.launches.get(k)}
        if missing or stray or r.foreign:
            fail(f"[sharded] depth {DEPTH} rank {i}: never launched {missing}; single-row madd {stray}; "
                 f"imported {r.foreign}")
    n_ok = verified([want[i] for i in SHARDED_VERIFY], vk_eid, vk_crs)
    if n_ok != len(SHARDED_VERIFY):
        fail(f"[sharded] depth {DEPTH}: {n_ok}/{len(SHARDED_VERIFY)} ballots verified")
    log(f"[sharded] vote_with_context(mesh=) at depth {DEPTH}, B = {BATCH}, points={SHARDED_POINTS} x voters=1, "
        f"gloo (host transport) on one card, beside the dry run: {wall:.3f} s for both; by rank: up after "
        f"{[round(r.ready_s, 3) for r in ranks]} s, then the batch (its device constants built) "
        f"{[round(r.seconds, 3) for r in ranks]} s; ballots byte-identical to [slice]'s unsharded batch on every "
        f"rank; voters {list(SHARDED_VERIFY)} verified; {gpu}")
    for i, r in enumerate(ranks):
        log(f"[sharded] depth {DEPTH} rank {i} launches: {r.launches}")
    return dict(dryrun=dry, wall_s=wall, rank_s=[r.seconds for r in ranks], launches=[r.launches for r in ranks])


def run_chain(gpu: str) -> dict:
    """[chain]: ``run_election`` at DEPTH with CHAIN_VOTERS voters on the
    card (setup and the Merkle tree there, one batch of every voter): every
    ballot accepted by the voter contract (status 0), the committed counts
    equal to the votes, the observer's verification true; setup's and the
    vote's kernels launched."""
    from vote_saver_tpu_torch import run_election
    from vote_saver_tpu_torch.ops import hopper_field as hf

    hf.reset_launches()
    try:
        out = run_election.run(DEPTH, CHAIN_VOTERS, SEED + 7, "cuda")
    except RuntimeError as exc:
        fail(f"[chain] {exc}")
    launches = _path_launches(SETUP_KERNELS + VOTE_KERNELS, "[chain]'s election")
    if out["status"] != [0] * CHAIN_VOTERS or out["verified"] is not True:
        fail(f"[chain] the election's result is not the one asked for: {out}")
    log(f"[chain] run_election at depth {DEPTH}, {CHAIN_VOTERS} voters: {CHAIN_VOTERS}/{CHAIN_VOTERS} ballots "
        f"accepted (status 0), counts {out['counts'][:CHAIN_VOTERS]}... equal to the votes, the observer's check "
        f"true; seconds {({k: round(v, 3) for k, v in out['times_s'].items()})}; {gpu}")
    return dict(out, launches=launches)


def _cli(argv: list) -> tuple[float, str]:
    """One run of the port's CLI in this process: (seconds, its stdout)."""
    import contextlib
    import io

    from vote_saver_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main([str(a) for a in argv])
    except SystemExit as exc:
        fail(f"the CLI's {argv[1]} phase exited with {exc.code}:\n{buf.getvalue()[-2000:]}")
    return time.perf_counter() - t0, buf.getvalue()


class _Service:
    """The port's JSON service as a subprocess on the card, one request
    and its response line at a time; its stdout must hold nothing else.
    A watchdog kills it after `timeout` seconds."""

    def __init__(self, timeout: float = 600):
        import subprocess

        self.proc = subprocess.Popen([sys.executable, "-m", "vote_saver_tpu_torch.frontends.service"], cwd=ROOT,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.watchdog = threading.Timer(timeout, self.proc.kill)
        self.watchdog.start()
        self.n = 0

    def call(self, method: str, params: dict) -> dict:
        self.proc.stdin.write(json.dumps({"id": self.n, "method": method, "params": params}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        try:
            resp = json.loads(line)
        except json.JSONDecodeError:
            fail(f"the service printed {line[:500]!r} for request {self.n} ({method})")
        if resp.get("id") != self.n or "error" in resp:
            fail(f"the service's response to request {self.n} ({method}): {line[:2000]}")
        self.n += 1
        return resp["result"]

    def close(self) -> None:
        """End the session: stdin closed, the process exits 0 having
        printed nothing past its responses."""
        try:
            rest, _ = self.proc.communicate(timeout=60)
        finally:
            self.watchdog.cancel()
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0 or rest:
            fail(f"the service exited with {self.proc.returncode} after printing {rest[:500]!r}")


def run_cli(rnd, gpu: str) -> dict:
    """The port's CLI over the depth-6 election, phase by phase in a
    temporary workdir under SEED: every voter's keys, setup and the Merkle
    tree on the card, one vote call of BATCH voters, their verification,
    the tally and its check, then ``--phase bench`` (B = 1) in a copy of the
    workdir without the ballots.  On the same artifacts: the JSON service
    as a subprocess (generate_vote, verify_vote, verify_tally) and one
    generate_vote through the C ABI's function pointers."""
    import base64
    import ctypes
    import shutil
    import tempfile

    from vote_saver_tpu_torch.frontends import c_api
    from vote_saver_tpu_torch.ops import hopper_field as hf
    from vote_saver_tpu_torch.params import MSG_SIZE
    from vote_saver_tpu_torch.protocol import marshal as M
    from vote_saver_tpu_torch.protocol import phases

    idx = list(range(BATCH))
    votes = [rnd.randrange(MSG_SIZE) for _ in idx]
    secs = {}
    with tempfile.TemporaryDirectory(prefix="vs_cli_") as tmp:
        wd = pathlib.Path(tmp) / "election"
        base = ["--tree-depth", DEPTH, "--seed", SEED, "--workdir", wd]
        hf.reset_launches()
        secs["init_voter"], _ = _cli(["--phase", "init_voter", *base])
        secs["init_admin"], _ = _cli(["--phase", "init_admin", *base])
        admin_launches = _path_launches((*SETUP_KERNELS, *MERKLE_KERNELS), "the CLI's init_admin")
        hf.reset_launches()
        secs["vote"], text = _cli(["--phase", "vote", *base, "--voter-idx", *idx, "--vote", *votes])
        vote_ms = re.search(r"Vote Phase Time_execution: (\d+)ms", text).group(1)
        vote_launches = _path_launches(VOTE_KERNELS, "the CLI's vote phase")
        secs["vote_verify"], text = _cli(["--phase", "vote_verify", *base, "--voter-idx", *idx])
        if text.count("verification: true") != BATCH:
            fail(f"the CLI verified {text.count('verification: true')}/{BATCH} ballots")
        secs["tally_admin"], _ = _cli(["--phase", "tally_admin", *base])
        secs["tally_voter"], text = _cli(["--phase", "tally_voter", *base])
        counts = M.de_scalar_vector_any((wd / "voting_result.bin").read_bytes())
        if counts != [votes.count(c) for c in range(MSG_SIZE)] or "verification: true" not in text:
            fail(f"the CLI's tally {counts} is not the votes {votes}, or did not verify")
        files = {p.stem: p.read_bytes() for p in wd.iterdir()}
        bench = pathlib.Path(tmp) / "bench"
        shutil.copytree(wd, bench, ignore=shutil.ignore_patterns("r1cs_*[0-9].bin", "cipher_text*", "sn*"))
        hf.reset_launches()
        secs["bench"], text = _cli(["--phase", "bench", "--tree-depth", DEPTH, "--seed", SEED, "--workdir", bench])
        bench_ms = re.search(r"Vote Phase Time_execution: (\d+)ms", text).group(1)
        _path_launches(B1_KERNELS, "the CLI's bench phase")
        bench_ok = phases.verify_ballot(*((bench / f"{n}0.bin").read_bytes() for n in (
            "r1cs_proof", "r1cs_primary_input", "cipher_text")), files["verification_key"], files["r1cs_verification_key"])
    if not bench_ok:
        fail("the CLI's bench ballot (B = 1) failed verify_ballot")
    log(f"[cli] depth {DEPTH}, {1 << DEPTH} voters, B={BATCH} in one vote call, then bench B=1: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f"; Vote Phase Time_execution {vote_ms} ms (B={BATCH}) and {bench_ms} ms (B=1); {BATCH}/{BATCH} ballots "
          f"and the bench ballot verified; counts equal the votes; {gpu}")
    log(f"[cli] launches: init_admin {({k: admin_launches[k] for k in (*SETUP_KERNELS, *MERKLE_KERNELS)})}, "
        f"vote {sum(vote_launches.values())}")

    b64 = lambda b: {"b64": base64.b64encode(b).decode()}  # noqa: E731
    names = ("r1cs_proving_key", "r1cs_verification_key", "public_key", "secret_key", "verification_key")
    keys = {n: b64(files[n]) for n in names}
    election = {"eid": b64(files["eid"]), "rt": b64(files["rt"]), "merkle_tree": b64(files["merkle_tree"])}
    cts = [b64(files[f"cipher_text{i}"]) for i in idx]
    voter = BATCH
    t0 = time.perf_counter()
    service = _Service()
    try:
        gen = service.call("generate_vote", dict(keys=keys, election=election, voter_idx=voter, vote=votes[0],
                                                 tree_depth=DEPTH, secret_key=b64(files[f"voter_secret_key{voter}"]),
                                                 seed=SEED + 5))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok_vote = service.call("verify_vote", {"keys": keys, "ballot": gen})
        ok_tally = service.call("verify_tally", {"keys": keys, "cts": cts, "tree_depth": DEPTH,
                                                 "voting_res": b64(files["voting_result"]),
                                                 "dec_proof": b64(files["decryption_proof"])})
        verify_s = time.perf_counter() - t0
    finally:
        service.close()
    if not (ok_vote["ok"] and ok_tally["ok"] and len(base64.b64decode(gen["proof"]["b64"])) == 192):
        fail(f"the service's ballot or tally did not verify: {ok_vote}, {ok_tally}")
    log(f"[cli] the JSON service (a subprocess on the card, stdout holding only its response lines): "
        f"generate_vote B=1 {first_s:.2f} s with the process's start, parse and kernel load, then verify_vote and "
        f"verify_tally {verify_s:.2f} s; the ballot and the CLI's tally verified; {gpu}")

    c_api.seed(SEED + 6)
    fns = {n: c_api._SIGS[n](a) for n, a in c_api.function_pointers().items()}
    keep = []

    def buf(blob: bytes = b""):
        arr = ctypes.create_string_buffer(blob, len(blob))
        p = ctypes.pointer(c_api.Buffer(len(blob), ctypes.cast(arr, ctypes.POINTER(ctypes.c_char))))
        keep.extend((arr, p))
        return p

    outs = [buf() for _ in range(4)]
    voter += 1
    hf.reset_launches()
    t0 = time.perf_counter()
    fns["generate_vote"](DEPTH, EID_BITS, voter, votes[1], *(buf(files[n]) for n in (
        "merkle_tree", "rt", "eid", f"voter_secret_key{voter}", "public_key", "r1cs_proving_key",
        "r1cs_verification_key")), *outs)
    abi_s = time.perf_counter() - t0
    _path_launches(B1_KERNELS, "the C ABI's generate_vote")
    proof, pinput, ct, _sn = (ctypes.string_at(o.contents.ptr, o.contents.size) for o in outs)
    if len(proof) != 192 or not phases.verify_ballot(proof, pinput, ct, files["verification_key"],
                                                     files["r1cs_verification_key"]):
        fail("the C ABI's ballot did not verify")
    for o in outs:
        fns["free_buffer"](o)
    log(f"[cli] the C ABI (c_api.function_pointers) generate_vote B=1 on the card: {abi_s:.2f} s; verified; {gpu}")
    return dict(seconds=secs, vote_ms=int(vote_ms), bench_ms=int(bench_ms), service_s=(first_s, verify_s),
                abi_s=abi_s)


def bound(work: dict, rates: dict) -> tuple[float, str]:
    """(bound_ms, bound_by) of one kernel's work on this card: bytes over
    HBM_BPS; 32x32->64 multiply-adds, 32-bit multiplies and issued
    instructions over ``micro.card_int_rates`` (documented per-SM rates on
    this card; multiply-adds at K9's measured rate where that is higher);
    float32 operations over F32_FLOPS; int8 products over INT8_OPS."""
    ops_s = max(work.get("mads", 0) / rates["mul_wide"], work.get("mul32", 0) / rates["mul32"],
                work.get("instrs", 0) / rates["issue"],
                work.get("f32_flops", 0) / F32_FLOPS, work.get("int8_ops", 0) / INT8_OPS)
    bytes_s = work["bytes"] / HBM_BPS
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def probe_entries(probes: dict) -> dict:
    """kernels-line fields of the probe kernels (K7-K10): max_abs_err, ms,
    plain_ms and the work their bound is computed from, all at the timed
    2^20 lanes.  max_abs_err is over every lane of the timed launch of a
    chain probe (and of its parity launch at the JAX probes' 14,336 lanes),
    and over every lane of K9's launch with per-lane inputs."""
    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch.ops import limbs as lb

    res = probes["res"]
    chain = {**{f"k7_{m}": r for m, r in res["field_mul"].items()},
             **{r["probe"]: r for r in res["yardstick"].values()},
             **{f"k8_{v}": r for v, r in res["cios_loop"].items()},
             **{f"k10_{m}": r for m, r in res["mul_chain"].items()}}
    out = {}
    for probe, r in chain.items():
        _idx, mode, chains, unroll, _mul = micro.CHAIN_PROBES[probe]
        muls = r["lanes"] * chains * unroll
        work = mode_work(dict(bytes=r["lanes"] * 4 * lb.FQ.num_limbs * (3 + (chains > 1)), mads=muls * MADS["fq"]),
                         mode)
        out[f"mul_chain_{probe}"] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], work=work,
                                         smem_bytes=r["smem_bytes"], warps_per_sm=r["warps_per_sm"])
    for kind, r in res["op_throughput"].items():
        # each step of a chain is at least one instruction (cvt: 256 steps of
        # two conversions); a float step is two flops (an FMA, or a mul and
        # an add); the multiply kinds add their multiplies
        iters = r["lanes"] * r["unroll"]
        work = dict(bytes=3 * 4 * r["lanes"])
        if kind.startswith("f32"):
            work["f32_flops"] = 2 * iters
        else:
            work["instrs"] = iters
            if kind in micro.MUL_WIDE_KINDS:
                work["mads"] = iters
            elif kind.startswith("u32_mul"):
                work["mul32"] = iters
        out[f"op_{kind}"] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], work=work)
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

    from vote_saver_tpu_torch import micro
    from vote_saver_tpu_torch import native_bridge as nb
    from vote_saver_tpu_torch.ops import _build
    from vote_saver_tpu_torch.ops import hopper_field as hf

    gpu = micro.gpu_line()
    log(gpu)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # the host library (g++) builds beside the CUDA kernels (nvcc)
    native = threading.Thread(target=nb.get_lib)
    native.start()
    kl = _build.load()
    native.join()
    if not nb.available():
        fail("the native host library did not build")
    log(f"[build] {', '.join(p.name for p in kl.paths)}: {kl.build_seconds:.1f} s")
    resources = {}
    for name, regs, spill in _build.resource_lines(kl.resource_usage):
        log(f"[build] {name}: {regs} registers, {spill} B spill stores")
        # the loop window sum's other team sizes are logged only
        if not (name.startswith("k_window_sum<") and not name.endswith(f",{hf.WINDOW_TEAM}>")):
            resources[instance_name(name)] = (regs, spill)
    sass = check_fold_sass(gpu)

    # each phase's wall seconds, for the run's time budget
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    rnd = random.Random(SEED)
    kern = phase("kernels", check_kernels, rnd)
    msm = phase("msm", check_msm, rnd)
    combine = msm["combine"]
    probes = phase("probes", run_probes, gpu)
    e = phase("election", election, DEPTH)
    setup_launches = phase("setup", check_setup, e)["launches"]
    _ntt, library = phase("ntt", check_ntt, gpu)
    phase("golden", check_golden)
    vote = phase("slice", run_slice, rnd, e, library)
    vote_launches = vote["launches"]
    for kname, rows in phase("path", check_path_kernels, vote).items():
        kern[kname]["shapes"] = rows
    modes = phase("modes", run_modes, e, vote, msm["cases"], library)
    phase("tally", run_tally, e, vote["device_batches"], gpu)
    phase("stream", run_stream, e, vote["device_batches"], rnd, library, gpu)
    phase("api", run_api, e, rnd, gpu)
    merkle_launches = phase("merkle", run_merkle, gpu)["launches"]
    scaled = phase("scale", run_scale, gpu)
    phase("cli", run_cli, rnd, gpu)
    phase("sharded", run_sharded, e, vote, gpu)
    phase("chain", run_chain, gpu)

    kern.update(probe_entries(probes))
    paths = dict.fromkeys((*SETUP_KERNELS, *OFF_SETUP_PATH), setup_launches)
    paths.update(dict.fromkeys((*VOTE_KERNELS, *OFF_VOTE_PATH), vote_launches))
    paths.update(dict.fromkeys(COMBINE_KERNELS, {k: combine[k[:2]]["addx"]["launches"].get(k, 0)
                                                 for k in COMBINE_KERNELS}))
    paths.update(dict.fromkeys((*K1_MODE_KERNELS, *micro.KERNELS), probes["launches"]))
    # each mode's instances: their launches on that mode's setup, batch and combination phase
    for mode, r in modes.items():
        paths.update({hf.instance(k, mode): r["setup"]["launches"] for k in (*SETUP_KERNELS, *OFF_SETUP_PATH)})
        paths.update({hf.instance(k, mode): r["launches"] for k in (*VOTE_KERNELS, *OFF_VOTE_PATH)})
        paths.update({hf.instance(k, mode): {hf.instance(k, mode): r["combine"][k[:2]]["addx"]["launches"].get(
            hf.instance(k, mode), 0)} for k in COMBINE_KERNELS})
    entries = []
    for k in (*hf.KERNELS, *micro.KERNELS):
        src = hf if k in hf.KERNELS else micro
        r = kern[k]
        bound_ms, bound_by = bound(r["work"], probes["res"]["rates"])
        regs, spill = resources.get(k, (None, None))
        entries.append(dict(name=k, route="cuda", source=src.SOURCES[k], replaces=src.REPLACES[k],
                            launches=paths[k][k], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                            registers=regs, spill_bytes=spill))
        if k in MERKLE_KERNELS:
            entries[-1]["merkle_launches"] = merkle_launches[k]
        if k in VOTE_KERNELS:
            # over [scale]'s two batches at each depth
            entries[-1]["scale_launches"] = {d: r["record"]["vote_launches"][k] for d, r in scaled.items()}
        if "warps_per_sm" in r:
            entries[-1].update(smem_bytes=r["smem_bytes"], warps_per_sm=r["warps_per_sm"])
        if k in sass:
            entries[-1]["sass"] = sass[k]
        if "fold" in r["work"]:
            entries[-1]["fold_bound_ms"] = bound(r["work"]["fold"], probes["res"]["rates"])[0]
        # a kernel faster than its bound would mean a rate above is not the card's peak
        note = "; FASTER THAN ITS BOUND" if r["ms"] < bound_ms else ""
        log(f"[bound] {k}: {r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / r['ms']:.1f}% of its time){note}{fold_bound(r['work'], probes['res']['rates'])}; "
            f"launches on its path {paths[k][k]}"
            + (f", on the Merkle build {merkle_launches[k]}" if k in MERKLE_KERNELS else "") + f"; {gpu}")
        # the chain kernels at the vote path's shapes: every row with its own bound
        if "chains" in r:
            entries[-1]["chains"] = []
            for row in r["chains"]:
                b_ms, b_by = bound(row["work"], probes["res"]["rates"])
                entries[-1]["chains"].append(dict({k2: row[k2] for k2 in (
                    "lanes", "times", "max_abs_err", "ms", "device_ms", "plain_ms")}, bound_ms=b_ms, bound_by=b_by))
                log(f"[bound] {k} at {row['lanes']} lanes x {row['times']}: {row['ms']:.4f} ms a call, device "
                    f"{_ms(row['device_ms'])} a launch, plain {row['plain_ms']:.3f} ms, against a bound of "
                    f"{b_ms:.5f} ms ({b_by}){fold_bound(row['work'], probes['res']['rates'])}; {gpu}")
        # the MSM kernels at the vote path's shapes, each row with its own bound
        if "shapes" in r:
            entries[-1]["shapes"] = []
            for row in r["shapes"]:
                b_ms, b_by = bound(row["work"], probes["res"]["rates"])
                entries[-1]["shapes"].append(dict({k2: row[k2] for k2 in (
                    "shape", "lanes", "max_abs_err", "ms", "device_ms", "plain_ms")}, bound_ms=b_ms, bound_by=b_by))
                plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.1f} ms"
                log(f"[bound] {k} at {row['shape']}: {row['ms']:.4f} ms a call, device {_ms(row['device_ms'])} "
                    f"a launch, plain {plain}, against a bound of {b_ms:.5f} ms ({b_by}, "
                    f"{100 * b_ms / row['ms']:.1f}% of its time){fold_bound(row['work'], probes['res']['rates'])}; {gpu}")
    log(f"[done] {time.perf_counter() - t_all:.1f} s (kernel build {kl.build_seconds:.1f} s; by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + ")")
    log(gpu)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
