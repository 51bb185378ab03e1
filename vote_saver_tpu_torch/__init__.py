"""vote_saver_tpu_torch — the PyTorch + CUDA (Hopper) port of vote_saver_tpu.

The JAX package ``vote_saver_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find:

  ops/        — limb field math, curve ops, NTT, scheduled MSM; the four
                hand-written CUDA kernels live in ``csrc/`` and are bound in
                ``ops/hopper_field.py`` (plain PyTorch twins beside them)
  protocol/   — Groth16 (device prover from a host witness), SAVER host
                arm, key parsing, the vote-phase functions
  convert.py  — carries arrays and keys across from the JAX package

This package imports ``torch`` and never ``jax``; from the JAX package it
imports only modules that are themselves jax-free (params, config,
refimpl, circuit, marshal's byte helpers, native_bridge, utils.rng).
"""

__version__ = "0.1.0"
