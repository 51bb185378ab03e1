"""Batched G1/G2 Jacobian arithmetic on limb tensors.

Counterpart of ``vote_saver_tpu/ops/curve_ops.py`` (JacobianOps and the
host <-> device point converters; EdwardsOps waits for the device-witness
slice).  Points are tuples (X, Y, Z) of int32 tensors, (..., L) for G1 and
(..., 2, L) for G2; infinity <=> Z == 0, canonical infinity (1, 1, 0).
``add`` and ``double`` are kernels K3 and K4 on CUDA tensors (their plain
versions on CPU), so every curve op of the slice rides the same kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vote_saver_tpu.params import Q
from vote_saver_tpu.refimpl import field as rf

from . import hopper_field as hf
from . import limbs as lb
from .field_ops import fq_ops
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

    def double(self, p):
        return hf.g2_double(p) if self.is_fq2 else hf.g1_double(p)

    def add(self, p, q):
        """Complete Jacobian addition (kernel K3)."""
        return hf.g2_add(p, q) if self.is_fq2 else hf.g1_add(p, q)

    def neg(self, p):
        return (p[0], self.f.neg(p[1]), p[2])

    def select(self, cond, p, q):
        return tuple(self.f.select(cond, a, b) for a, b in zip(p, q))

    # -- helpers ------------------------------------------------------------

    def scalar_mul_windowed(self, p, digits_lsb_first, window: int = 4):
        """p * k with k as (..., W) base-2^window digits, LSB window first.

        A 2^window-entry multiples table (table[d] = d * p), then W steps of
        `window` doublings + one table-lookup add, MSB window first."""
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
            for _ in range(window):
                acc = self.double(acc)
            acc = self.add(acc, lookup(digits[..., w]))
        return acc

    def sum_reduce(self, p, axis: int = 0):
        """Log-depth Hillis-Steele sum of points over `axis` (step s adds
        points[i + 2^s] into points[i]; index 0 ends with the total)."""
        coords = tuple(torch.movedim(c, axis, 0) for c in p)
        n = coords[0].shape[0]
        if n == 1:
            return tuple(c[0] for c in coords)
        idx = torch.arange(n, device=coords[0].device)
        for s in range((n - 1).bit_length()):
            shift = 1 << s
            shifted = tuple(torch.roll(c, -shift, dims=0) for c in coords)
            added = self.add(coords, shifted)
            valid = (idx + shift < n).reshape((n,) + (1,) * (coords[0].dim() - 1))
            coords = tuple(torch.where(valid, a, c) for a, c in zip(added, coords))
        return tuple(c[0] for c in coords)

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
# Host <-> device point converters
# ---------------------------------------------------------------------------


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
