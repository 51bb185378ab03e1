"""Carry state across from the JAX package.

Limb arrays of the JAX package (numpy or jax arrays, ``(B, L)`` or
``(B, 2, L)``) come in two layouts: 16-bit limbs in uint32 (the TPU/Pallas
layout, L = 24 / 16) and 32-bit limbs in uint64 (the CPU rig, L = 12 / 8).
Montgomery R is 2^384 / 2^256 in both, and in this package's layout, so a
value converts by repacking limbs only.  ``proving_key_from_jax`` rebuilds
this package's ProvingKey from a JAX one, so both sides prove from one CRS;
``fixed_base_table_from_jax``, ``pedersen_tables_from_jax`` and
``window_tables_from_jax`` carry the setup's window table, the device
witness's Pedersen window constants and the Merkle hash's window tables.
This module never imports jax: it reads arrays through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import limbs as lb
from .protocol import groth16


def from_jax_limbs(arr, device="cpu") -> torch.Tensor:
    """JAX limb array (16-bit limbs in uint32 or 32-bit limbs in uint64) ->
    this package's int32 tensor of 32-bit limbs (same leading shape)."""
    a = np.asarray(arr)
    if a.dtype == np.uint64:
        return lb.to_tensor(a.astype(np.uint32), device)
    if a.dtype == np.uint32:
        if a.shape[-1] % 2:
            raise ValueError("16-bit layout needs an even limb count")
        u = a.astype(np.uint64)
        return lb.to_tensor((u[..., 0::2] | (u[..., 1::2] << np.uint64(16))).astype(np.uint32), device)
    raise TypeError(f"unexpected JAX limb dtype {a.dtype}")


def to_jax_limbs(t: torch.Tensor, limb_bits: int) -> np.ndarray:
    """This package's int32 tensor -> JAX layout: limb_bits 32 gives uint64
    32-bit limbs, 16 gives uint32 16-bit limbs."""
    a = lb.from_tensor(t)
    if limb_bits == 32:
        return a.astype(np.uint64)
    if limb_bits == 16:
        lo, hi = a & np.uint32(0xFFFF), a >> np.uint32(16)
        return np.stack([lo, hi], axis=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],)).astype(np.uint32)
    raise ValueError(f"limb_bits must be 16 or 32, got {limb_bits}")


def fixed_base_table_from_jax(table, device="cpu") -> tuple[torch.Tensor, ...]:
    """A JAX ``FixedBaseTable.table`` (Jacobian limb arrays (W, 2^bw, ...))
    -> this package's table coordinates, as ``ops.msm.FixedBaseTable.table``."""
    return tuple(from_jax_limbs(c, device) for c in table)


def pedersen_tables_from_jax(xs4, ys4, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A JAX witness program's Pedersen window constants (``xs4``/``ys4``,
    (W, 4, L) Montgomery limbs) -> this package's (W, 4, 8) int32 tensors."""
    return from_jax_limbs(xs4, device), from_jax_limbs(ys4, device)


def window_tables_from_jax(tables, device="cpu") -> tuple[torch.Tensor, ...]:
    """The JAX ``pedersen_ops.window_tables`` (extended Edwards (X, Y, Z, T)
    limb arrays (W, 8, ...)) -> this package's ``ops.pedersen_ops``
    tables, (W, 8, 8) int32 tensors."""
    return tuple(from_jax_limbs(c, device) for c in tables)


def proving_key_from_jax(pk) -> groth16.ProvingKey:
    """This package's ProvingKey from a ``vote_saver_tpu`` ProvingKey."""
    return groth16.ProvingKey(
        num_primary=pk.num_primary, num_vars=pk.num_vars, domain=pk.domain,
        a_pts=list(pk.a_pts), b1_pts=list(pk.b1_pts), b2_pts=list(pk.b2_pts),
        h_pts=list(pk.h_pts), l_pts=list(pk.l_pts),
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        coo=pk.coo, num_constraints=pk.num_constraints,
    )


def verification_key_from_jax(vk) -> groth16.VerificationKey:
    return groth16.VerificationKey(alpha_g1=vk.alpha_g1, beta_g2=vk.beta_g2, gamma_g2=vk.gamma_g2,
                                   delta_g2=vk.delta_g2, ic=list(vk.ic))
