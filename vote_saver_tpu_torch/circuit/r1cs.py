"""Rank-1 constraint system over Fr with batched witness storage.

A linear combination is a dict {var_index: coeff}; variable 0 is the constant
ONE.  Constraints are A·B = C triples.  The system compiles to COO sparse
tensors consumed by the device prover (matrix-times-witness evaluations).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import R


def lc(*terms) -> dict:
    """lc((var, coeff), ...) -> linear combination dict (coeffs mod R)."""
    out = {}
    for var, coeff in terms:
        c = (out.get(var, 0) + coeff) % R
        if c:
            out[var] = c
        elif var in out:
            del out[var]
    return out


def lc_add(a: dict, b: dict) -> dict:
    out = dict(a)
    for v, c in b.items():
        n = (out.get(v, 0) + c) % R
        if n:
            out[v] = n
        elif v in out:
            del out[v]
    return out


def lc_scale(a: dict, s: int) -> dict:
    s %= R
    return {v: c * s % R for v, c in a.items()} if s else {}


ONE = 0  # index of the constant-one variable


class ConstraintSystem:
    def __init__(self):
        self.num_vars = 1  # var 0 is ONE
        self.constraints: list[tuple[dict, dict, dict]] = []
        self.num_primary = 0  # vars 1..num_primary are the public input

    def alloc(self) -> int:
        v = self.num_vars
        self.num_vars += 1
        return v

    def alloc_vec(self, n: int) -> list[int]:
        return [self.alloc() for _ in range(n)]

    def constrain(self, a: dict, b: dict, c: dict):
        self.constraints.append((a, b, c))

    def set_input_sizes(self, n: int):
        self.num_primary = n

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    # -- evaluation (oracle / tests) ----------------------------------------

    def eval_lc(self, l: dict, w: np.ndarray):
        """w: (..., num_vars) object array -> (...,) object array."""
        acc = np.zeros(w.shape[:-1], dtype=object)
        for v, c in l.items():
            acc = (acc + c * w[..., v]) % R
        return acc

    def is_satisfied(self, w: np.ndarray) -> bool:
        for i, (a, b, c) in enumerate(self.constraints):
            av, bv, cv = self.eval_lc(a, w), self.eval_lc(b, w), self.eval_lc(c, w)
            if not np.all((av * bv - cv) % R == 0):
                return False
        return True

    def first_unsatisfied(self, w: np.ndarray) -> int | None:
        for i, (a, b, c) in enumerate(self.constraints):
            av, bv, cv = self.eval_lc(a, w), self.eval_lc(b, w), self.eval_lc(c, w)
            if not np.all((av * bv - cv) % R == 0):
                return i
        return None

    # -- export for the device prover ---------------------------------------

    def to_coo(self):
        """-> dict with, per matrix M in (a, b, c): rows, cols (int32 arrays)
        and coeffs (object array of ints); used to evaluate M·w on device."""
        out = {}
        for name, idx in (("a", 0), ("b", 1), ("c", 2)):
            rows, cols, coeffs = [], [], []
            for r_i, con in enumerate(self.constraints):
                for v, c in con[idx].items():
                    rows.append(r_i)
                    cols.append(v)
                    coeffs.append(c)
            out[name] = (
                np.asarray(rows, np.int32),
                np.asarray(cols, np.int32),
                np.asarray(coeffs, dtype=object),
            )
        return out


@dataclasses.dataclass
class Witness:
    """Batched assignment: values[(batch, num_vars)] object ints, values[:,0]=1."""

    values: np.ndarray

    @classmethod
    def zeros(cls, batch: int, num_vars: int) -> "Witness":
        v = np.zeros((batch, num_vars), dtype=object)
        v[:, ONE] = 1
        return cls(v)

    def set(self, var, vals):
        self.values[:, var] = np.asarray(vals, dtype=object) % R

    def get(self, var):
        return self.values[:, var]

    def primary(self, num_primary: int) -> np.ndarray:
        return self.values[:, 1 : 1 + num_primary]

    def auxiliary(self, num_primary: int) -> np.ndarray:
        return self.values[:, 1 + num_primary :]
