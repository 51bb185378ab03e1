"""Batched G1/G2 Jacobian arithmetic on limb tensors.

Counterpart of ``vote_saver_tpu/ops/curve_ops.py``: JacobianOps, the
JubJub EdwardsOps of the device witness, and the host <-> device point
converters.  Jacobian points are tuples (X, Y, Z) of int32 tensors, (..., L)
for G1 and (..., 2, L) for G2; infinity <=> Z == 0, canonical infinity
(1, 1, 0).  ``add``, ``add_distinct`` and ``double`` are kernels K3, K3d and
K4 on CUDA tensors (their plain versions on CPU), so every curve op rides
the same kernels.  Edwards points are (X, Y, Z, T) over Fr in Montgomery
form; their field multiplies are kernel K1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import JUBJUB_D, Q, R
from ..refimpl import field as rf
from . import hopper_field as hf
from . import limbs as lb
from .field_ops import fq_ops, fr_ops
from .fq2_ops import Fq2Ops, fq2_ops


class JacobianOps:
    """Short-Weierstrass y^2 = x^3 + b with a = 0, over FieldOps or Fq2Ops."""

    def __init__(self, f):
        self.f = f
        self.is_fq2 = isinstance(f, Fq2Ops)
        self.tail = 2 if self.is_fq2 else 1  # trailing coordinate dims

    # -- constructors -------------------------------------------------------

    def _one_like(self, x_coord):
        fq = self.f.fq if self.is_fq2 else self.f
        out = torch.zeros_like(x_coord)
        one = fq.const("one_mont", x_coord.device)
        if self.is_fq2:
            out[..., 0, :] = one
        else:
            out[...] = one
        return out

    def infinity_like(self, x_coord):
        one = self._one_like(x_coord)
        return (one, one.clone(), torch.zeros_like(one))

    def is_inf(self, p):
        return self.f.is_zero(p[2])

    # -- group law ----------------------------------------------------------

    def double(self, p, times: int = 1):
        """`times` doublings in one launch of kernel K4."""
        return hf.g2_double(p, times) if self.is_fq2 else hf.g1_double(p, times)

    def add(self, p, q):
        """Complete Jacobian addition (kernel K3)."""
        return hf.g2_add(p, q) if self.is_fq2 else hf.g1_add(p, q)

    def add_distinct(self, p, q):
        """Jacobian add assuming p != +-q whenever both are finite (kernel
        K3d: no doubling branch).  Safe for window-decomposition sums, whose
        partial sums cover disjoint scalar bit ranges; NOT for arbitrary
        operands."""
        return hf.g2_add_distinct(p, q) if self.is_fq2 else hf.g1_add_distinct(p, q)

    def neg(self, p):
        return (p[0], self.f.neg(p[1]), p[2])

    def select(self, cond, p, q):
        return tuple(self.f.select(cond, a, b) for a, b in zip(p, q))

    # -- helpers ------------------------------------------------------------

    def scalar_mul_bits(self, p, bits_msb_first):
        """p * k with k as a (..., nbits) 0/1 array, MSB first; p's coords
        and the bits broadcast over leading dims.  A doubling (K4) and an
        add (K3) a bit, the add kept where the bit is set."""
        bits = torch.as_tensor(np.asarray(bits_msb_first, dtype=np.int64), device=p[0].device)
        acc = self.infinity_like(p[0])
        for k in range(bits.shape[-1]):
            acc = self.double(acc)
            acc = self.select(bits[..., k] == 1, self.add(acc, p), acc)
        return acc

    def scalar_mul_windowed(self, p, digits_lsb_first, window: int = 4):
        """p * k with k as (..., W) base-2^window digits, LSB window first.

        A 2^window-entry multiples table (table[d] = d * p), then W steps of
        `window` doublings (one K4 launch) + one table-lookup add, MSB window
        first."""
        digits = torch.as_tensor(digits_lsb_first, device=p[0].device).to(torch.int64)
        lead = torch.broadcast_shapes(digits.shape[:-1], p[0].shape[: p[0].dim() - self.tail])
        digits = digits.expand(tuple(lead) + digits.shape[-1:])
        p = tuple(c.expand(tuple(lead) + tuple(c.shape[c.dim() - self.tail:])) for c in p)
        entries = [self.infinity_like(p[0]), p]
        for _ in range((1 << window) - 2):
            entries.append(self.add(entries[-1], p))
        table = tuple(torch.stack([e[k] for e in entries]) for k in range(3))

        def lookup(dig):
            idx = dig.reshape((1,) + tuple(lead) + (1,) * self.tail)
            idx = idx.expand((1,) + tuple(table[0].shape[1:]))
            return tuple(torch.gather(t, 0, idx)[0] for t in table)

        acc = self.infinity_like(p[0])
        for w in range(digits.shape[-1] - 1, -1, -1):
            acc = self.add(self.double(acc, times=window), lookup(digits[..., w]))
        return acc

    def sum_reduce(self, p, axis: int = 0, distinct: bool = False):
        """Log-depth Hillis-Steele sum of points over `axis` (step s adds
        points[i + 2^s] into points[i]; index 0 ends with the total).
        distinct=True uses add_distinct (valid when every partial sum is
        provably distinct, e.g. window decompositions)."""
        return hf.tree_sum(self.add_distinct if distinct else self.add, p, axis)

    def to_affine(self, p):
        """Fermat-inversion affine conversion; infinity maps to (0, 0)."""
        f = self.f
        x, y, z = p
        zinv = f.inv(z)
        zinv2 = f.sq(zinv)
        ax = f.mul(x, zinv2)
        ay = f.mul(y, f.mul(zinv, zinv2))
        inf = self.is_inf(p)
        return (f.select(inf, torch.zeros_like(ax), ax), f.select(inf, torch.zeros_like(ay), ay))


@functools.cache
def g1_ops() -> JacobianOps:
    return JacobianOps(fq_ops())


@functools.cache
def g2_ops() -> JacobianOps:
    return JacobianOps(fq2_ops())


# ---------------------------------------------------------------------------
# JubJub extended twisted Edwards (a = -1) over Fr: complete addition, no
# selects
# ---------------------------------------------------------------------------


class EdwardsOps:
    def __init__(self):
        self.f = fr_ops()
        self.k2d = lb.ints_to_tensor([2 * JUBJUB_D % R], lb.FR)[0]  # Montgomery form
        self._dev: dict = {}

    def _k2d(self, device):
        key = lb.device_of(device)
        if key not in self._dev:
            self._dev[key] = self.k2d.to(key)
        return self._dev[key]

    def identity_like(self, x_coord):
        """(0, 1, 1, 0) shaped like x_coord."""
        zero = torch.zeros_like(x_coord)
        one = self.f.const("one_mont", x_coord.device).expand_as(x_coord).clone()
        return (zero, one, one.clone(), zero.clone())

    def add(self, p, q):
        """Hisil-Wong-Carter-Dawson a = -1 extended addition (complete on
        the odd-order subgroup): 9 multiplies in 3 stacked K1 launches on
        the card, the 4 independent products, then * 2d, then the 4
        outputs."""
        f = self.f
        x1, y1, z1, t1, x2, y2, z2, t2 = torch.broadcast_tensors(*p, *q)
        a, b, tt, d = f.mul(torch.stack([f.sub(y1, x1), f.add(y1, x1), t1, z1]),
                            torch.stack([f.sub(y2, x2), f.add(y2, x2), t2, z2])).unbind(0)
        c = f.mul(tt, self._k2d(t1.device))
        d = f.add(d, d)
        e = f.sub(b, a)
        ff = f.sub(d, c)
        g = f.add(d, c)
        h = f.add(b, a)
        return tuple(f.mul(torch.stack([e, g, ff, e]), torch.stack([ff, h, g, h])).unbind(0))

    def sum_reduce(self, p, axis: int = 0):
        """Log-depth Hillis-Steele sum over `axis` (complete addition, so
        out-of-range lanes are only left unchanged)."""
        return hf.tree_sum(self.add, p, axis)

    def to_affine(self, p):
        """(x, y) = (X / Z, Y / Z): one Fermat inversion (K1's chain in one
        launch on the card) and two multiplies."""
        f = self.f
        x, y, z, _ = p
        zinv = f.inv(z)
        return f.mul(x, zinv), f.mul(y, zinv)


@functools.cache
def jj_ops() -> EdwardsOps:
    return EdwardsOps()


def jj_to_device(points, device="cpu"):
    """Affine Edwards int points -> extended Montgomery tensors (X, Y, 1, XY)."""
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    ts = [p[0] * p[1] % R for p in points]
    return tuple(lb.ints_to_tensor(v, lb.FR, device) for v in (xs, ys, [1] * len(points), ts))


def jj_from_device(p):
    """Extended Montgomery tensors -> list of affine Edwards int points."""
    xs, ys, zs = (np.atleast_1d(lb.tensor_to_ints(c, lb.FR)) for c in p[:3])
    out = []
    for i in range(xs.shape[0]):
        zi = pow(int(zs[i]), R - 2, R)
        out.append((int(xs[i]) * zi % R, int(ys[i]) * zi % R))
    return out


# ---------------------------------------------------------------------------
# Host <-> device point converters
# ---------------------------------------------------------------------------


def scalars_to_bits_msb(scalars, nbits=255) -> np.ndarray:
    """Ints -> (n, nbits) uint32 bit array, MSB first (for scalar_mul_bits)."""
    arr = np.asarray(scalars, dtype=object).reshape(-1)
    out = np.zeros((arr.shape[0], nbits), dtype=np.uint32)
    for i, v in enumerate(arr):
        v = int(v)
        for k in range(nbits):
            out[i, nbits - 1 - k] = (v >> k) & 1
    return out


def g1_to_device(points, device="cpu"):
    """Affine int points / None -> Jacobian Montgomery tensors (n, L)."""
    xs = [p[0] if p is not None else 1 for p in points]
    ys = [p[1] if p is not None else 1 for p in points]
    zs = [1 if p is not None else 0 for p in points]
    return tuple(lb.ints_to_tensor(v, lb.FQ, device) for v in (xs, ys, zs))


def g2_to_device(points, device="cpu"):
    zero2, one2 = (0, 0), (1, 0)
    xs = [p[0] if p is not None else one2 for p in points]
    ys = [p[1] if p is not None else one2 for p in points]
    zs = [one2 if p is not None else zero2 for p in points]
    return tuple(lb.ints_to_tensor(v, lb.FQ, device) for v in (xs, ys, zs))


# batches this large convert on the device (Fermat inversion through K1);
# smaller ones invert on the host
_DEVICE_AFFINE_MIN = 64


def _jacobian_from_device(p, fq2: bool):
    lead_dims = 2 if fq2 else 1
    p = tuple(c.reshape((-1,) + tuple(c.shape[c.dim() - lead_dims:])) for c in p)
    n = p[0].shape[0]
    if n >= _DEVICE_AFFINE_MIN:
        ops = g2_ops() if fq2 else g1_ops()
        ax, ay = ops.to_affine(p)
        inf = ops.is_inf(p).cpu().numpy()
        xs = lb.tensor_to_ints(ax, lb.FQ)
        ys = lb.tensor_to_ints(ay, lb.FQ)
        out = []
        for i in range(n):
            if inf[i]:
                out.append(None)
            elif fq2:
                out.append((tuple(int(v) for v in xs[i]), tuple(int(v) for v in ys[i])))
            else:
                out.append((int(xs[i]), int(ys[i])))
        return out
    xs, ys, zs = (np.atleast_1d(lb.tensor_to_ints(c, lb.FQ)) for c in p)
    out = []
    for i in range(n):
        if fq2:
            z = tuple(int(v) for v in zs[i])
            if z == (0, 0):
                out.append(None)
                continue
            zi = rf.fq2_inv(z)
            zi2 = rf.fq2_sq(zi)
            x = rf.fq2_mul(tuple(int(v) for v in xs[i]), zi2)
            y = rf.fq2_mul(tuple(int(v) for v in ys[i]), rf.fq2_mul(zi, zi2))
            out.append((x, y))
        else:
            z = int(zs[i])
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, Q - 2, Q)
            out.append((int(xs[i]) * zi * zi % Q, int(ys[i]) * zi * zi % Q * zi % Q))
    return out


def g1_from_device(p):
    """Jacobian device point(s) -> list of affine int points / None."""
    return _jacobian_from_device(p, fq2=False)


def g2_from_device(p):
    return _jacobian_from_device(p, fq2=True)
