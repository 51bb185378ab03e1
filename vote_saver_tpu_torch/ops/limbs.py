"""Host <-> tensor codec for the port's fixed limb layout.

The layout is fixed once here and never read from the environment (the JAX
package's ``params.fq_spec()``/``fr_spec()`` follow ``VSTPU_LIMB_BITS``):
32-bit little-endian limbs, Montgomery R = 2^384 (Fq) / 2^256 (Fr).  On the
host a limb array is ``uint32``; as a tensor it is ``torch.int32`` holding
the same bit patterns, which is exactly the memory the CUDA kernels read as
``uint32_t*``.
"""

from __future__ import annotations

import numpy as np
import torch

from vote_saver_tpu.params import FieldSpec, Q, R

FQ = FieldSpec("fq", Q, 32, 12)
FR = FieldSpec("fr", R, 32, 8)


def spec_for(name: str) -> FieldSpec:
    return FQ if name == "fq" else FR


def ints_to_limbs(xs, spec: FieldSpec) -> np.ndarray:
    """Int / nested list of ints -> uint32 limb array (..., L), reduced mod p."""
    arr = np.asarray(xs, dtype=object)
    nbytes = 4 * spec.num_limbs
    flat = arr.reshape(-1)
    buf = b"".join((int(v) % spec.modulus).to_bytes(nbytes, "little") for v in flat)
    out = np.frombuffer(buf, dtype="<u4").astype(np.uint32)
    return out.reshape(arr.shape + (spec.num_limbs,))


def limbs_to_ints(limbs, spec: FieldSpec):
    """uint32 (or int32) limb array (..., L) -> object array of ints."""
    a = np.ascontiguousarray(np.asarray(limbs).astype(np.uint32, copy=False))
    lead = a.shape[:-1]
    raw = a.reshape(-1, spec.num_limbs).astype("<u4").tobytes()
    nbytes = 4 * spec.num_limbs
    out = np.empty(len(raw) // nbytes, dtype=object)
    for i in range(out.shape[0]):
        out[i] = int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
    return out.reshape(lead) if lead else out[0]


def ints_to_mont_limbs(xs, spec: FieldSpec) -> np.ndarray:
    arr = np.asarray(xs, dtype=object)
    mont = np.empty(arr.shape, dtype=object)
    flat, mflat = arr.reshape(-1), mont.reshape(-1)
    for i in range(flat.shape[0]):
        mflat[i] = spec.to_mont(int(flat[i]) % spec.modulus)
    return ints_to_limbs(mont, spec)


def mont_limbs_to_ints(limbs, spec: FieldSpec):
    vals = limbs_to_ints(limbs, spec)
    if isinstance(vals, np.ndarray):
        flat = vals.reshape(-1)
        for i in range(flat.shape[0]):
            flat[i] = spec.from_mont(int(flat[i]))
        return vals
    return spec.from_mont(int(vals))


def to_tensor(limbs: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 limb array -> int32 tensor with the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(limbs).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def ints_to_tensor(xs, spec: FieldSpec, device="cpu", mont: bool = True) -> torch.Tensor:
    conv = ints_to_mont_limbs if mont else ints_to_limbs
    return to_tensor(conv(xs, spec), device)


def tensor_to_ints(t: torch.Tensor, spec: FieldSpec, mont: bool = True):
    conv = mont_limbs_to_ints if mont else limbs_to_ints
    return conv(from_tensor(t), spec)
