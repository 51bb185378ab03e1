"""Variable-base MSM and the fixed-base window table.

Counterpart of ``msm_var_base``, ``msm_pippenger``, ``FixedBaseTable``,
``scalars_to_window_digits`` and ``limbs_to_window_digits`` in
``vote_saver_tpu/ops/msm.py``.  ``msm_var_base`` is the complete-formula
fallback of the scheduled MSM, run when a mixed-add lane flags the doubling
corner: every add is the complete K3 and every doubling K4, so no corner
exists on it.  ``FixedBaseTable`` multiplies many scalars by one base (the
CRS in Groth16 setup): a table entry per 8-bit window, summed by the
distinct-operand add K3d in the JAX scan's tree, the gather and the sum in
one launch on the card (``hopper_field.g1_window_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import R
from ..refimpl import jacobian as rj
from . import curve_ops as co
from . import hopper_field as hf
from .curve_ops import JacobianOps

FB_WINDOW = 4
FB_NUM_WINDOWS = (255 + FB_WINDOW - 1) // FB_WINDOW  # 64


def msm_var_base(ops: JacobianOps, points, scalar_digits):
    """sum_i scalars[i] * points[i] over the point axis.

    points: Jacobian coords with leading dim n; scalar_digits: (..., n, W)
    4-bit windows LSB first (extra leading dims batch independent MSMs over
    the same points).  Returns coords with the digits' extra leading dims."""
    digits = torch.as_tensor(scalar_digits, device=points[0].device)
    per_point = ops.scalar_mul_windowed(points, digits)
    return ops.sum_reduce(per_point, axis=digits.dim() - 2)


def _segmented_tree_sum(ops: JacobianOps, points, seg_ids: torch.Tensor):
    """Hillis-Steele segmented suffix sum over a bucket-sorted point axis
    (dim 1; dim 0 batches independent rows): after log2(n) rounds position
    i holds the sum of the run of equal seg_ids starting at i, so a run's
    head holds the run's sum."""
    n = seg_ids.shape[1]
    idx = torch.arange(n, device=seg_ids.device)
    for s in range((n - 1).bit_length()):
        shift = 1 << s
        shifted = tuple(torch.roll(c, -shift, dims=1) for c in points)
        valid = (idx + shift < n) & (torch.roll(seg_ids, -shift, dims=1) == seg_ids)
        added = ops.add(points, shifted)
        points = ops.select(valid, added, points)
    return points


def msm_pippenger(ops: JacobianOps, points, scalar_limbs, window_bits: int = 8):
    """Pippenger MSM with sort-based bucket accumulation, as the JAX
    package's: each window sorts its points by digit (stably), sums runs
    of equal digits by the segmented tree, puts each run's head in its
    bucket, then the running-sum pass sum_b b * S_b from the top bucket
    down; Horner combines the windows, MSB first.  Every window runs at
    once on a leading window axis.

    points: Jacobian coords with leading dim n; scalar_limbs: (n, 8) plain
    little-endian Fr limbs, int32 tensor or uint32 array.  window_bits
    must divide the 32-bit limb."""
    if 32 % window_bits:
        raise ValueError(f"window_bits {window_bits} does not divide the 32-bit limb")
    dev = points[0].device
    limbs = torch.as_tensor(np.asarray(scalar_limbs).astype(np.uint32).view(np.int32)
                            if isinstance(scalar_limbs, np.ndarray) else scalar_limbs, device=dev)
    n = points[0].shape[0]
    num_windows = 256 // window_bits
    nbuckets = 1 << window_bits
    # (W, n) window digits, LSB window first
    shifts = torch.arange(32 // window_bits, device=dev) * window_bits
    digits = ((limbs.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shifts) & (nbuckets - 1)
    digits = digits.reshape(n, num_windows).t()
    sorted_dig, order = torch.sort(digits, dim=1, stable=True)
    tail = tuple(points[0].shape[1:])
    summed = _segmented_tree_sum(ops, tuple(c[order] for c in points), sorted_dig)
    idx = torch.arange(n, device=dev)
    live = ((idx == 0) | (sorted_dig != torch.roll(sorted_dig, 1, dims=1))) & (sorted_dig != 0)
    w_idx, p_idx = torch.nonzero(live, as_tuple=True)
    buckets = []
    for inf, c in zip(ops.infinity_like(points[0][:1]), summed):
        b = inf.expand((num_windows, nbuckets) + tail).clone()
        b[w_idx, sorted_dig[w_idx, p_idx]] = c[w_idx, p_idx]
        buckets.append(b)
    # running-sum trick: sum_b b * S_b is the sum of the suffix sums
    inf0 = ops.infinity_like(points[0][:1].expand((num_windows,) + tail))
    running, total = inf0, inf0
    for b in range(nbuckets - 1, 0, -1):
        running = ops.add(running, tuple(c[:, b] for c in buckets))
        total = ops.add(total, running)
    acc = ops.infinity_like(points[0][0])
    for w in range(num_windows - 1, -1, -1):
        acc = ops.add(ops.double(acc, times=window_bits), tuple(c[w] for c in total))
    return acc


class FixedBaseTable:
    """Host-built table entry[w][d] = d * 2^(bw*w) * base (entry 0 of each
    row is infinity), as Jacobian tensors (W, 2^bw, ...): 8-bit windows and
    32 of them by default (the card's window sum takes only that shape).
    The per-scalar window sum uses distinct-operand adds: partial sums cover
    disjoint scalar bit ranges, so no true doubling occurs (infinity is
    handled by the kernel's selects).  Its digits are ``digits()``'s, not
    the 4-bit ``scalars_to_window_digits`` defaults."""

    def __init__(self, base_affine_int, group: str = "g1", window_bits: int = 8):
        self.group = group
        self.window_bits = window_bits
        self.num_windows = (255 + window_bits - 1) // window_bits
        # d * 2^(bw*w) * base by native host fixed-base multiplication: the
        # same points the JAX package reaches by repeated affine adds
        scalars = [d << (window_bits * w) for w in range(self.num_windows) for d in range(1 << window_bits)]
        entries = rj.FixedBaseHost(base_affine_int, group).mul_many(scalars)
        to_dev = co.g1_to_device if group == "g1" else co.g2_to_device
        self.table = tuple(c.reshape(self.num_windows, 1 << window_bits, *c.shape[1:])
                           for c in to_dev(entries))
        self._dev: dict = {}

    def mul(self, ops: JacobianOps, digits, device="cpu"):
        """digits: (n, W) window digits (LSB window first) -> (n,) points."""
        key = str(device)
        if key not in self._dev:  # the table is copied to each device once
            self._dev[key] = tuple(c.to(device) for c in self.table)
        table = self._dev[key]
        hf.check_window_digits(digits, 1 << self.window_bits)  # on the host, before they go up
        d = torch.as_tensor(digits, device=table[0].device).to(torch.int32).contiguous()
        window_sum = hf.g2_window_sum if ops.is_fq2 else hf.g1_window_sum
        return window_sum(table, d, checked=True)

    def digits(self, scalars) -> np.ndarray:
        """Ints -> (n, W) int32 window digits, LSB window first."""
        return scalars_to_window_digits(scalars, self.window_bits, self.num_windows)


def scalars_to_window_digits(scalars, window=FB_WINDOW, num_windows=FB_NUM_WINDOWS) -> np.ndarray:
    """Ints (reduced mod R) -> (n, num_windows) int32 base-2^window digits,
    LSB window first."""
    le = b"".join((int(v) % R).to_bytes(32, "little") for v in np.asarray(scalars, dtype=object).reshape(-1))
    bits = np.unpackbits(np.frombuffer(le, np.uint8).reshape(-1, 32), axis=1, bitorder="little")
    nb = window * num_windows
    bits = np.pad(bits, ((0, 0), (0, max(0, nb - 256))))[:, :nb]
    weights = 1 << np.arange(window, dtype=np.int64)
    return (bits.reshape(-1, num_windows, window).astype(np.int64) @ weights).astype(np.int32)


def limbs_to_window_digits(limbs: torch.Tensor, window: int = FB_WINDOW) -> torch.Tensor:
    """Plain LE 32-bit scalar limbs (..., 8) int32 -> (..., 256/window) int32
    window digits, LSB window first."""
    x = limbs.to(torch.int64) & 0xFFFFFFFF
    per = 32 // window
    shifts = torch.arange(per, device=limbs.device) * window
    digs = (x[..., :, None] >> shifts) & ((1 << window) - 1)
    return digs.flatten(-2).to(torch.int32)
