"""Scheduled-bucket Pippenger MSM: host schedule + device bucket scan.

Counterpart of ``vote_saver_tpu/ops/msm_sched.py``.  The JAX module imports
jax at the top, so its host half is carried here as a jax-free copy:
signed digits, the conflict-free schedule (native ``sched_pass1/2`` from
``native/vs_native.cpp`` when built, the numpy argsort path otherwise),
orphan sub-bucket merge plans and shape unification.  The device half runs
the same algebra on torch tensors:

  * bucket scan: one K2 (mixed add) launch per schedule row, after an
    ``index_select`` gather of the row's affine points (code = pidx+1 |
    sign << 30; 0 = idle lane), updating the accumulator in place;
  * orphan runs: segmented-tree rounds of K3 on the live lanes only, then
    one K3 round adding each run head into its canonical bucket;
  * combination: Hillis-Steele suffix sums over the bucket axis (K3, twice),
    then a Horner pass over windows (w K4 doublings + one K3 add each).

Lane padding is the port's own: 128 lanes (one CUDA thread block of the
kernels), the same granularity the JAX package uses off the TPU, so the two
build identical schedules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vote_saver_tpu import native_bridge as nb

from . import curve_ops as co
from . import limbs as lb

_IDX_MASK = (1 << 30) - 1
_LANE_PAD = 128
_MROUNDS = 10  # segmented-tree merge rounds
_MAX_CHUNKS = 1 << _MROUNDS  # per-bucket chunk cap; beyond it `steps` escalates
_STEP_GRID = [16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
              256, 320, 384, 448, 512, 640, 768, 1024, 1536, 2048, 3072,
              4096, 6144, 8192]
DEFAULT_WINDOW_BITS = 10


# ---------------------------------------------------------------------------
# Host side: signed digits + conflict-free schedule
# ---------------------------------------------------------------------------


def _bits_from_limbs(limbs: np.ndarray, nbits: int) -> np.ndarray:
    """(n, L) uint32 32-bit limbs -> (n, nbits) 0/1 int64 matrix."""
    n, L = limbs.shape
    shifts = np.arange(32, dtype=np.uint64)
    bits = (limbs[:, :, None].astype(np.uint64) >> shifts) & np.uint64(1)
    bits = bits.reshape(n, L * 32).astype(np.int64)
    if bits.shape[1] < nbits:
        bits = np.pad(bits, ((0, 0), (0, nbits - bits.shape[1])))
    return bits[:, :nbits]


def _as_limbs(scalar_limbs) -> np.ndarray:
    if isinstance(scalar_limbs, torch.Tensor):
        return lb.from_tensor(scalar_limbs)
    return np.asarray(scalar_limbs).astype(np.uint32, copy=False)


def signed_digits(scalars, window_bits: int, scalar_limbs=None, scalar_bits: int = 256) -> np.ndarray:
    """Scalars -> (n, K) int32 signed digits in [-2^(w-1), 2^(w-1)],
    sum_j d_j 2^(w j) == scalar.  ``scalar_limbs``: (n, 8) plain LE limbs."""
    w = window_bits
    nbits = scalar_bits + w  # headroom for the final carry window
    K = nbits // w + (1 if nbits % w else 0)
    if scalar_limbs is None:
        scalar_limbs = lb.ints_to_limbs(np.asarray(scalars, dtype=object), lb.FR)
    limbs = _as_limbs(scalar_limbs)
    n = limbs.shape[0]
    bits = _bits_from_limbs(limbs, K * w)
    digs = bits.reshape(n, K, w) @ (1 << np.arange(w, dtype=np.int64))
    out = np.zeros((n, K), dtype=np.int64)
    carry = np.zeros(n, dtype=np.int64)
    half, full = 1 << (w - 1), 1 << w
    for j in range(K):
        raw = digs[:, j] + carry
        over = raw > half
        out[:, j] = np.where(over, raw - full, raw)
        carry = over.astype(np.int64)
    if carry.any():
        raise ValueError("scalar overflowed the digit windows")
    return out.astype(np.int32)


@dataclasses.dataclass
class Schedule:
    """Device-ready conflict-free bucket schedule with orphan sub-buckets
    (see the JAX package's ``msm_sched.Schedule``)."""

    codes: np.ndarray  # (steps, lanes) int32: 0 = idle; else (pidx+1) | sign<<30
    merge_part: np.ndarray  # (_MROUNDS, lanes - canon) int32 partner position+1
    merge_gather: np.ndarray  # (canon,) int32 orphan-run head position+1
    window_bits: int
    num_windows: int  # windows per part
    lanes: int
    total_entries: int
    num_parts: int = 1


def _pad_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _grid_up(x: int) -> int:
    for g in _STEP_GRID:
        if g >= x:
            return g
    return _pad_up(x, _STEP_GRID[-1])


def _fit_shape(loads: np.ndarray, total: int, canon: int):
    """(steps, lanes, orph_cnt): grid-quantised schedule shape, escalated
    until every bucket fits _MAX_CHUNKS chunks and the orphan region."""
    lam = total / max(canon, 1)
    steps = _grid_up(max(16, int(lam * 1.15) + 2))
    lanes = _pad_up(canon + max(1024, canon // 8), _LANE_PAD)
    while True:
        chunks = -(-loads // steps) if total else np.zeros(canon, np.int64)
        orph_cnt = np.maximum(chunks - 1, 0)
        max_chunks = int(chunks.max()) if total else 0
        if int(orph_cnt.sum()) <= lanes - canon and max_chunks <= _MAX_CHUNKS:
            return steps, lanes, orph_cnt.astype(np.int64)
        steps = _grid_up(steps + 1)


def _merge_arrays(orph_cnt: np.ndarray, canon: int, lanes: int):
    """Segmented-tree merge plan: (part, gather, orph_base)."""
    orph_len = lanes - canon
    part = np.zeros((_MROUNDS, orph_len), np.int32)
    gather = np.zeros(canon, np.int32)
    orph_base = np.zeros(canon, np.int64)
    n_orph = int(orph_cnt.sum())
    if n_orph:
        orph_base[1:] = np.cumsum(orph_cnt, dtype=np.int64)[:-1]
        bsel = np.nonzero(orph_cnt)[0]
        reps = orph_cnt[bsel]
        base_rep = np.repeat(orph_base[bsel], reps)
        pos = np.arange(n_orph, dtype=np.int64)
        within = pos - base_rep
        cnt_rep = np.repeat(reps, reps)
        for r in range(_MROUNDS):
            sh = 1 << r
            m = within + sh < cnt_rep
            part[r, pos[m]] = (pos[m] + sh + 1).astype(np.int32)
        gather[bsel] = (orph_base[bsel] + 1).astype(np.int32)
    return part, gather, orph_base


def build_schedule(scalars=None, window_bits: int = DEFAULT_WINDOW_BITS, inf_mask=None,
                   scalar_limbs=None, scalar_bits: int = 256) -> Schedule:
    """Assign every nonzero (window, point) digit to (step, bucket-lane)."""
    if nb.available() and scalar_bits >= 256:
        if scalar_limbs is None:
            scalar_limbs = lb.ints_to_limbs(np.asarray(scalars, dtype=object), lb.FR)
        return _schedule_native([scalar_limbs], window_bits, inf_mask)
    digs = signed_digits(scalars, window_bits, scalar_limbs=scalar_limbs, scalar_bits=scalar_bits)
    return _schedule_from_digits(digs, window_bits, inf_mask, num_parts=1)


def build_schedule_multi(scalar_limbs_list, window_bits: int = DEFAULT_WINDOW_BITS,
                         inf_mask=None) -> Schedule:
    """One schedule for B scalar vectors over a shared point set: windows of
    part i live at window offset i*K."""
    if nb.available():
        return _schedule_native(scalar_limbs_list, window_bits, inf_mask)
    digs = np.concatenate(
        [signed_digits(None, window_bits, scalar_limbs=sl) for sl in scalar_limbs_list], axis=1
    )
    return _schedule_from_digits(digs, window_bits, inf_mask, num_parts=len(scalar_limbs_list))


def _limbs_to_le_bytes(scalar_limbs) -> np.ndarray:
    """(n, 8) 32-bit limbs (uint32 array or int32 tensor) -> (n, 32) uint8."""
    a = np.ascontiguousarray(_as_limbs(scalar_limbs)).astype("<u4", copy=False)
    out = a.view(np.uint8).reshape(a.shape[0], -1)
    if out.shape[1] != 32:
        raise ValueError(f"expected (n, 8) Fr limbs, got {a.shape}")
    return out


def _schedule_native(scalar_limbs_list, w: int, inf_mask) -> Schedule:
    parts = len(scalar_limbs_list)
    n = int(np.asarray(_as_limbs(scalar_limbs_list[0])).shape[0])
    sc_bytes = np.ascontiguousarray(
        np.concatenate([_limbs_to_le_bytes(sl) for sl in scalar_limbs_list])
    )
    total, digits, counts = nb.sched_pass1(sc_bytes, parts, n, w, inf_mask)
    K = digits.shape[1]
    canon = parts * K * (1 << (w - 1))
    loads = counts.sum(axis=0, dtype=np.int64)
    steps, lanes, orph_cnt = _fit_shape(loads, total, canon)
    part, gather, orph_base = _merge_arrays(orph_cnt, canon, lanes)
    codes = nb.sched_pass2(
        digits, parts, n, w, inf_mask, counts, orph_base.astype(np.int32), steps, steps, lanes
    )
    return Schedule(codes, part, gather, w, K, lanes, total, parts)


def _schedule_from_digits(digs, w, inf_mask, num_parts):
    n, K = digs.shape  # K = windows_per_part * num_parts here
    bw = 1 << (w - 1)
    canon = K * bw
    point_idx, win_idx = np.meshgrid(np.arange(n), np.arange(K), indexing="ij")
    flat_d = digs.reshape(-1)
    flat_p = point_idx.reshape(-1)
    flat_w = win_idx.reshape(-1)
    keep = flat_d != 0
    if inf_mask is not None:
        keep &= ~np.asarray(inf_mask, dtype=bool)[flat_p]
    d, p, wn = flat_d[keep], flat_p[keep], flat_w[keep]
    lane = wn * bw + (np.abs(d) - 1)
    sign = (d < 0).astype(np.int64)
    total = int(lane.shape[0])
    loads = np.bincount(lane, minlength=canon).astype(np.int64)
    steps, lanes, orph_cnt = _fit_shape(loads, total, canon)
    part, gather, orph_base = _merge_arrays(orph_cnt, canon, lanes)
    order = np.argsort(lane, kind="stable")
    lane_s, p_s, sign_s = lane[order], p[order], sign[order]
    first_pos = np.searchsorted(lane_s, lane_s, side="left")
    occ = np.arange(total) - first_pos
    chunk = occ // steps  # 0 = canonical accumulator, >= 1 spills to orphans
    step = occ % steps
    entry_lane = np.where(chunk == 0, lane_s, canon + orph_base[lane_s] + chunk - 1)
    codes = np.zeros((steps, lanes), dtype=np.int32)
    codes[step, entry_lane] = (p_s + 1) | (sign_s << 30)
    assert K % num_parts == 0
    return Schedule(codes, part, gather, w, K // num_parts, lanes, total, num_parts)


def unify_schedule_shapes(*schedules: Schedule) -> None:
    """Pad same-(K, w, parts) schedules to one (steps, lanes) shape in place
    (zero codes / zero merge entries are idle lanes)."""
    assert len({(s.num_windows, s.window_bits, s.num_parts) for s in schedules}) == 1
    steps = max(s.codes.shape[0] for s in schedules)
    lanes = max(s.lanes for s in schedules)
    canon = schedules[0].merge_gather.shape[0]
    for s in schedules:
        assert s.merge_gather.shape[0] == canon
        if s.codes.shape == (steps, lanes):
            continue
        c = np.zeros((steps, lanes), np.int32)
        c[: s.codes.shape[0], : s.codes.shape[1]] = s.codes
        m = np.zeros((_MROUNDS, lanes - canon), np.int32)
        m[:, : s.merge_part.shape[1]] = s.merge_part
        s.codes, s.merge_part, s.lanes = c, m, lanes


def g1_affine_to_device(points, device="cpu"):
    """Affine int points (None -> (0, 0), the madd kernel's idle encoding)."""
    xs = [p[0] if p is not None else 0 for p in points]
    ys = [p[1] if p is not None else 0 for p in points]
    return (lb.ints_to_tensor(xs, lb.FQ, device), lb.ints_to_tensor(ys, lb.FQ, device))


def g2_affine_to_device(points, device="cpu"):
    zero2 = (0, 0)
    xs = [p[0] if p is not None else zero2 for p in points]
    ys = [p[1] if p is not None else zero2 for p in points]
    return (lb.ints_to_tensor(xs, lb.FQ, device), lb.ints_to_tensor(ys, lb.FQ, device))


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def _ops(group: str) -> co.JacobianOps:
    return co.g1_ops() if group == "g1" else co.g2_ops()


def _madd(group: str):
    from . import hopper_field as hf

    return hf.g1_madd if group == "g1" else hf.g2_madd


def _live_add(ops, coords, partner_pos: np.ndarray):
    """coords[i] += coords[partner_pos[i] - 1] for every i with a nonzero
    entry (K3 on the live lanes only; all reads precede the writes)."""
    live = np.nonzero(partner_pos)[0]
    if live.size == 0:
        return coords
    dev = coords[0].device
    dst = torch.from_numpy(live).to(dev)
    src = torch.from_numpy(partner_pos[live].astype(np.int64) - 1).to(dev)
    added = ops.add(tuple(c.index_select(0, dst) for c in coords),
                    tuple(c.index_select(0, src) for c in coords))
    return tuple(c.index_copy(0, dst, a) for c, a in zip(coords, added))


def _suffix_and_total(ops, acc, K: int, bw: int):
    """acc coords with leading dim K*bw -> per-window weighted sums
    S_w = sum_b (b+1) acc[w, b], coords (K, ...).  Two passes of the masked
    Hillis-Steele suffix round: buckets -> suffix sums -> their sum.  Equal
    operands occur routinely (empty bucket ranges), so the add is complete."""
    coords = tuple(c[: K * bw].reshape((K, bw) + tuple(c.shape[1:])) for c in acc)
    if bw > 1:
        idx = torch.arange(bw, device=coords[0].device)
        inf = ops.infinity_like(coords[0])
        for _ in range(2):
            for s in range((bw - 1).bit_length()):
                shift = 1 << s
                valid = (idx + shift < bw).reshape((1, bw) + (1,) * (coords[0].dim() - 2))
                rolled = tuple(
                    torch.where(valid, torch.roll(c, -shift, dims=1), i) for c, i in zip(coords, inf)
                )
                coords = ops.add(coords, rolled)
    return tuple(c[:, 0] for c in coords)


def _top_window(sched: Schedule) -> int:
    """Highest window index (over all parts) whose buckets receive any entry;
    -1 when every window is empty."""
    canon = sched.merge_gather.shape[0]
    used = (sched.codes[:, :canon] != 0).any(axis=0) | (sched.merge_gather != 0)
    per_window = used.reshape(sched.num_parts, sched.num_windows, -1).any(axis=(0, 2))
    nz = np.nonzero(per_window)[0]
    return int(nz[-1]) if nz.size else -1


def _horner(ops, window_sums, w: int, parts: int, top: int):
    """result[p] = sum_j 2^(w j) S_{p, j}, MSB window first, batched over
    parts; returns coords with leading dim (parts,).  Windows above `top`
    are empty: their sums are the canonical infinity (1, 1, 0), which the
    doubling and the complete add both map to itself, so starting at `top`
    gives the same limbs as running every window."""
    coords = tuple(c.reshape((parts, c.shape[0] // parts) + tuple(c.shape[1:])) for c in window_sums)
    acc = ops.infinity_like(coords[0][:, 0])
    for j in range(top, -1, -1):
        for _ in range(w):
            acc = ops.double(acc)
        acc = ops.add(acc, tuple(c[:, j] for c in coords))
    return acc


def msm_device(group: str, points_xy, sched: Schedule):
    """Run one scheduled MSM on the points' device (the JAX package's
    ``_msm_device`` + ``msm_scheduled_async``: launches only, the exception
    flag stays on the device).  Returns (Jacobian coords with leading dim
    (parts,), exceptional flag tensor () bool)."""
    ops = _ops(group)
    madd = _madd(group)
    px, py = points_xy
    dev = px.device
    lanes = sched.codes.shape[1]
    canon = sched.merge_gather.shape[0]
    bw = 1 << (sched.window_bits - 1)
    tail = tuple(px.shape[1:])
    acc = ops.infinity_like(torch.zeros((lanes,) + tail, dtype=torch.int32, device=dev))
    exc = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    codes = torch.from_numpy(np.ascontiguousarray(sched.codes)).to(dev)
    for row in codes:
        active = row != 0
        sign = ((row >> 30) & 1) != 0
        pidx = ((row & _IDX_MASK) - 1).clamp(min=0)
        q = (px.index_select(0, pidx), py.index_select(0, pidx))
        acc, e = madd(acc, q, sign, active, out=acc)
        exc |= e
    # fold orphan runs into their heads, then heads into canonical lanes
    # (complete adds on the live lanes; idle rounds are skipped on the host)
    can = tuple(c[:canon] for c in acc)
    if sched.merge_part.shape[1] and sched.merge_gather.any():
        orph = tuple(c[canon:] for c in acc)
        for part_row in sched.merge_part:
            orph = _live_add(ops, orph, part_row)
        live = np.nonzero(sched.merge_gather)[0]
        dst = torch.from_numpy(live).to(dev)
        src = torch.from_numpy(sched.merge_gather[live].astype(np.int64) - 1).to(dev)
        added = ops.add(tuple(c.index_select(0, dst) for c in can),
                        tuple(c.index_select(0, src) for c in orph))
        can = tuple(c.index_copy(0, dst, a) for c, a in zip(can, added))
    sums = _suffix_and_total(ops, can, sched.num_windows * sched.num_parts, bw)
    res = _horner(ops, sums, sched.window_bits, sched.num_parts, _top_window(sched))
    return res, (exc != 0).any()


def msm_scheduled(group: str, points_xy, sched: Schedule, fallback=None):
    """Scheduled MSM with the complete-formula fallback: if any madd lane
    hit its doubling corner, return ``fallback()`` instead (zero-arg
    callable giving Jacobian coords with leading dim (parts,))."""
    res, exc = msm_device(group, points_xy, sched)
    if bool(exc):
        if fallback is None:
            raise RuntimeError("scheduled MSM hit the madd doubling corner and no fallback was provided")
        return fallback()
    return res


def var_base_fallback(group: str, points_host, scalars, device="cpu"):
    """Zero-arg fallback: complete-formula var-base MSM of int scalars."""

    def run():
        from . import msm as msm_mod

        conv = co.g1_to_device if group == "g1" else co.g2_to_device
        digits = msm_mod.scalars_to_window_digits(scalars)
        res = msm_mod.msm_var_base(_ops(group), conv(points_host, device), digits)
        return tuple(c[None] for c in res)

    return run
