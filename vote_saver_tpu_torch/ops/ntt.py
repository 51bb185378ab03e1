"""NTT over Fr for the Groth16 H(X) = (A*B - C)/Z_H division.

Counterpart of ``vote_saver_tpu/ops/ntt.py``, with its two paths chosen by
an argument, ``NTT(n, path)`` / ``get_ntt(n, path)``, never by the
environment:

  * ``"radix2"``: decimation in time with a host bit-reversal permutation
    and per-stage twiddle tables in Montgomery limbs; each stage is one
    batched K1 multiply plus plain-PyTorch add/sub over every butterfly of
    every batch row;
  * ``"matmul"``: the Bailey 4-step of ``ops/ntt_mxu.py`` (the JAX
    package's MXU path), int8 digit products with the coset factors and
    1/n folded into its constant matrices.

``choose_path`` is the prover's rule: a CUDA device takes ``"matmul"`` for
a domain of at least 2^12 (the JAX package's rule, with the card in the
TPU's place), every other case ``"radix2"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from . import limbs as lb
from . import ntt_mxu
from .field_ops import fr_ops

PATHS = ("radix2", "matmul")
MATMUL_MIN_N = 1 << 12


def choose_path(path: str | None, n: int, device) -> str:
    """The NTT path for a domain of n on `device`: `path` itself when given
    (an unknown one raises), else "matmul" on a CUDA device for n >= 2^12
    and "radix2" otherwise."""
    if path is None:
        return "matmul" if torch.device(device).type == "cuda" and n >= MATMUL_MIN_N else "radix2"
    return _checked(path)


def _checked(path: str) -> str:
    if path not in PATHS:
        raise ValueError(f"unknown NTT path {path!r}; expected one of {PATHS}")
    return path


class NTT:
    def __init__(self, n: int, path: str = "radix2"):
        assert n & (n - 1) == 0, "domain size must be a power of two"
        assert n <= (1 << FR_TWO_ADICITY)
        self.n = n
        self.path = _checked(path)
        self.k = n.bit_length() - 1
        self.f = fr_ops()
        self.w = pow(FR_ROOT_OF_UNITY, (1 << FR_TWO_ADICITY) // n, R)
        self.w_inv = pow(self.w, R - 2, R)
        self.n_inv = pow(n, R - 2, R)
        g = FR_GENERATOR
        # Z_H on the coset g*H is the constant g^n - 1; its inverse
        zh_coset = (pow(g, n, R) - 1) % R
        self._host = {"zh_coset_inv": lb.ints_to_mont_limbs(pow(zh_coset, R - 2, R), lb.FR)}
        self._dev: dict = {}
        if self.path == "radix2":
            self._radix2_tables()

    def _radix2_tables(self) -> None:
        n = self.n
        rev = np.zeros(n, dtype=np.int64)
        for i in range(n):
            rev[i] = int(bin(i)[2:].zfill(self.k)[::-1], 2) if self.k else 0
        self.bitrev = rev
        self._host["bitrev"] = rev
        # stage s: 2^s butterflies per block, twiddle_j = w^(n / 2^(s+1) * j)
        for s in range(self.k):
            half = 1 << s
            step = n // (2 * half)
            self._host[f"tw_fwd{s}"] = lb.ints_to_mont_limbs([pow(self.w, step * j, R) for j in range(half)], lb.FR)
            self._host[f"tw_inv{s}"] = lb.ints_to_mont_limbs([pow(self.w_inv, step * j, R) for j in range(half)], lb.FR)
        g = FR_GENERATOR
        g_inv = pow(g, R - 2, R)
        self._host["coset_pows"] = lb.ints_to_mont_limbs(_powers(g, n), lb.FR)
        self._host["coset_pows_inv"] = lb.ints_to_mont_limbs(_powers(g_inv, n), lb.FR)
        self._host["n_inv"] = lb.ints_to_mont_limbs(self.n_inv, lb.FR)

    def table(self, name: str, device) -> torch.Tensor:
        device = lb.device_of(device)
        key = (name, str(device))
        if key not in self._dev:
            arr = self._host[name]
            t = torch.from_numpy(arr) if name == "bitrev" else lb.to_tensor(arr)
            self._dev[key] = t.to(device)
        return self._dev[key]

    def _core(self, x, kind: str):
        """x: (..., n, L) Montgomery limbs, already bit-reversed."""
        f, n, L = self.f, self.n, x.shape[-1]
        shp = x.shape[:-2]
        for s in range(self.k):
            half = 1 << s
            x = x.reshape(*shp, n // (2 * half), 2 * half, L)
            even, odd = x[..., :half, :], x[..., half:, :]
            t = f.mul(odd, self.table(f"tw_{kind}{s}", x.device))
            x = torch.cat([f.add(even, t), f.sub(even, t)], dim=-2).reshape(*shp, n, L)
        return x

    def ntt(self, coeffs):
        """Coefficients -> evaluations on the size-n subgroup (natural order)."""
        if self.path == "matmul":
            return ntt_mxu.get_plan(self.n, "fwd").apply(coeffs)
        x = coeffs.index_select(-2, self.table("bitrev", coeffs.device))
        return self._core(x, "fwd")

    def intt(self, evals):
        """Evaluations -> coefficients."""
        if self.path == "matmul":
            return ntt_mxu.get_plan(self.n, "inv").apply(evals)
        x = evals.index_select(-2, self.table("bitrev", evals.device))
        x = self._core(x, "inv")
        return self.f.mul(x, self.table("n_inv", x.device))

    def coset_ntt(self, coeffs):
        """Evaluate on the coset g*H (g = Fr multiplicative generator)."""
        if self.path == "matmul":
            return ntt_mxu.get_plan(self.n, "fwd_coset").apply(coeffs)
        return self.ntt(self.f.mul(coeffs, self.table("coset_pows", coeffs.device)))

    def coset_intt(self, evals):
        if self.path == "matmul":
            return ntt_mxu.get_plan(self.n, "inv_coset").apply(evals)
        coeffs = self.intt(evals)
        return self.f.mul(coeffs, self.table("coset_pows_inv", coeffs.device))


def _powers(g: int, n: int) -> list[int]:
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * g % R
    return out


@functools.cache
def get_ntt(n: int, path: str = "radix2") -> NTT:
    return NTT(n, path)
