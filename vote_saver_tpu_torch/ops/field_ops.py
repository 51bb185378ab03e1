"""Batched Montgomery field arithmetic on int32 limb tensors (Fr, Fq).

Counterpart of ``vote_saver_tpu/ops/field_ops.py``.  ``mul`` is kernel K1
(``hopper_field.mont_mul``) on CUDA tensors and its plain version on CPU,
``inv`` K1's Fermat chain in one launch (``hopper_field.mont_inv``), both
in the multiplier mode ``VSTPU_MUL`` names (``hopper_field.mul_mode``);
add/sub/neg/reduce_lazy are plain PyTorch on 16-bit half-limbs with
vectorised carry resolution (a few dozen tensor ops each, no per-limb
loop).  The JAX package's f32-matmul column-sum multiply is a TPU device
trick with no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from . import hopper_field as hf
from .limbs import FQ, FR


class FieldOps:
    """Batched modular arithmetic for one prime field in Montgomery form."""

    def __init__(self, spec):
        self.spec = spec
        self.name = spec.name
        self.L = spec.num_limbs
        self.half = hf.HALF[self.name]
        self._consts = {
            "one_mont": spec.to_mont(1),
            "one_std": 1,
            "r2": spec.mont_r2,
        }
        self._dev: dict = {}

    def const(self, name: str, device) -> torch.Tensor:
        """A field constant as an (L,) int32 tensor on `device`."""
        key = (name, str(device))
        if key not in self._dev:
            v = self._consts[name]
            limbs = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(self.L)]
            self._dev[key] = torch.tensor(
                [x - (1 << 32) if x >= 1 << 31 else x for x in limbs], dtype=torch.int32
            ).to(device)
        return self._dev[key]

    def mul(self, a, b):
        """Montgomery product (a * b * R^-1) mod N; broadcasts."""
        return hf.mont_mul(self.name, a, b)

    def sq(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return hf._pack(self.half.add(hf._half(a), hf._half(b)))

    def sub(self, a, b):
        return hf._pack(self.half.sub(hf._half(a), hf._half(b)))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None], a, b)

    def to_mont(self, a_std):
        return self.mul(a_std, self.const("r2", a_std.device))

    def from_mont(self, a_mont):
        return self.mul(a_mont, self.const("one_std", a_mont.device))

    def reduce_lazy(self, cols):
        """Montgomery-reduce int64 lazy columns (..., K <= 2L) at 32-bit
        positions (value = sum cols_k 2^(32k), each column < 2^40, value <
        R * N) -> canonical (..., L): value * R^-1 mod N."""
        half = torch.stack((cols & 0xFFFF, cols >> 16), dim=-1).flatten(-2)
        return hf._pack(self.half.redc(half))

    def pow_fixed(self, a, exp_bits):
        """a^e with e given as a static MSB-first bit sequence: a square a
        bit, a multiply a set bit (K1 each)."""
        res = self.const("one_mont", a.device).expand(a.shape)
        for bit in exp_bits:
            res = self.sq(res)
            if int(bit):
                res = self.mul(res, a)
        return res

    def batch_inv(self, a):
        """Montgomery's trick over the leading axis: the prefix products,
        one inversion (``inv``) of their total, then the walk back; (n, ...,
        L) -> (n, ..., L).  A zero entry gives garbage (callers mask it), as
        in the JAX package."""
        one = self.const("one_mont", a.device).expand(a.shape[1:])
        prefix = [one]  # prefix[i]: the product of a[:i]
        for x in a[:-1]:
            prefix.append(self.mul(prefix[-1], x))
        acc = self.inv(self.mul(prefix[-1], a[-1]))
        out = [None] * a.shape[0]
        for i in range(a.shape[0] - 1, -1, -1):
            out[i] = self.mul(acc, prefix[i])
            acc = self.mul(acc, a[i])
        return torch.stack(out)

    def inv(self, a):
        """Fermat inversion a^(N-2) (``hopper_field.mont_inv``: the whole
        square-and-multiply chain in one K1 launch on the card); zero maps
        to zero, as in the JAX package (callers mask zeros)."""
        return hf.mont_inv(self.name, a)


@functools.cache
def fr_ops() -> FieldOps:
    return FieldOps(FR)


@functools.cache
def fq_ops() -> FieldOps:
    return FieldOps(FQ)
