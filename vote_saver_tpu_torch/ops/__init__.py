"""Device ops on torch tensors: limb field math, curves, NTT, scheduled MSM.

Field elements are ``torch.int32`` tensors ``(..., L)`` holding the uint32
bit patterns of 32-bit little-endian limbs in Montgomery form (L = 12 for
Fq, 8 for Fr); Fq2 elements are ``(..., 2, L)``.
"""
