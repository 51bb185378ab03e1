"""vote_saver_tpu_torch — the PyTorch + CUDA (Hopper) port of vote_saver_tpu.

The JAX package ``vote_saver_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find:

  ops/        — limb field math, curve ops, NTT, scheduled MSM; the
                hand-written CUDA kernels live in ``csrc/`` and are bound in
                ``ops/hopper_field.py`` (plain PyTorch twins beside them)
  circuit/    — R1CS, the voting circuit, the device witness
  protocol/   — Groth16, SAVER, key parsing, the phase functions
  sdk.py, cli.py, frontends/
              — the entry points: the SDK, the CLI
                (``python -m vote_saver_tpu_torch.cli``), the JSON-over-stdio
                service and the C ABI
  refimpl/, params.py, config.py, chain/, utils/, native_bridge.py
              — the host oracle, constants, the chain layer, seeded
                randomness, logging and profiling, and the native host
                library's bridge
  micro.py    — the multiply probes K7-K10 (``python -m vote_saver_tpu_torch.micro``)
  convert.py  — carries arrays and keys across from the JAX package

This package imports ``torch`` and nothing of ``jax`` or of the JAX
package: what it needs from the JAX package's jax-free modules it keeps as
its own copies at the same relative paths.  The tests are where the two
meet.  Entry points run on the card (``device="cuda"``) unless the caller
names another device.
"""

__version__ = "0.1.0"
