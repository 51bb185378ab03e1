"""Variable-base MSM: the complete-formula fallback of the scheduled MSM.

Counterpart of ``msm_var_base``, ``scalars_to_window_digits`` and
``limbs_to_window_digits`` in ``vote_saver_tpu/ops/msm.py``.  Runs when a
mixed-add lane flags the doubling corner; every add is the complete K3 and
every doubling K4, so no corner exists on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from vote_saver_tpu.params import R

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


def scalars_to_window_digits(scalars, window=FB_WINDOW, num_windows=FB_NUM_WINDOWS) -> np.ndarray:
    arr = np.asarray(scalars, dtype=object).reshape(-1)
    out = np.zeros((arr.shape[0], num_windows), dtype=np.int32)
    mask = (1 << window) - 1
    for i, v in enumerate(arr):
        v = int(v) % R
        for w in range(num_windows):
            out[i, w] = (v >> (window * w)) & mask
    return out


def limbs_to_window_digits(limbs: torch.Tensor, window: int = FB_WINDOW) -> torch.Tensor:
    """Plain LE 32-bit scalar limbs (..., 8) int32 -> (..., 256/window) int32
    window digits, LSB window first."""
    x = limbs.to(torch.int64) & 0xFFFFFFFF
    per = 32 // window
    shifts = torch.arange(per, device=limbs.device) * window
    digs = (x[..., :, None] >> shifts) & ((1 << window) - 1)
    return digs.flatten(-2).to(torch.int32)
