"""Pure-Python-integer oracle: fields, curves, Jacobian host ops, pairing,
Pedersen.

The port's copies of the modules of ``vote_saver_tpu/refimpl/``, verbatim
apart from their import lines; the host MSM, fixed-base and pairing paths
dispatch to ``vote_saver_tpu_torch.native_bridge``.
"""
