"""Batched Fq2 = Fq[u]/(u^2 + 1) arithmetic on (..., 2, L) int32 tensors.

Counterpart of ``vote_saver_tpu/ops/fq2_ops.py``: Karatsuba over
:class:`FieldOps`; the three base multiplies of one Fq2 multiply go to the
device as one batched K1 launch.
"""

from __future__ import annotations

import functools

import torch

from .field_ops import fq_ops


class Fq2Ops:
    def __init__(self):
        self.fq = fq_ops()

    @staticmethod
    def _pack(c0, c1):
        return torch.stack([c0, c1], dim=-2)

    def add(self, a, b):
        return self.fq.add(a, b)

    def sub(self, a, b):
        return self.fq.sub(a, b)

    def neg(self, a):
        return self.fq.neg(a)

    def mul(self, a, b):
        f = self.fq
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        t = f.mul(
            torch.stack([a0, a1, f.add(a0, a1)], dim=-2),
            torch.stack([b0, b1, f.add(b0, b1)], dim=-2),
        )
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        return self._pack(f.sub(t0, t1), f.sub(t2, f.add(t0, t1)))

    def sq(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t = f.mul(self._pack(f.add(a0, a1), a0), self._pack(f.sub(a0, a1), a1))
        t0, t1 = t[..., 0, :], t[..., 1, :]
        return self._pack(t0, f.add(t1, t1))

    def inv(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        norm = f.add(f.mul(a0, a0), f.mul(a1, a1))
        ninv = f.inv(norm)
        return self._pack(f.mul(a0, ninv), f.neg(f.mul(a1, ninv)))

    def is_zero(self, a):
        return (a == 0).all(dim=-1).all(dim=-1)

    def eq(self, a, b):
        return (a == b).all(dim=-1).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)


@functools.cache
def fq2_ops() -> Fq2Ops:
    return Fq2Ops()
