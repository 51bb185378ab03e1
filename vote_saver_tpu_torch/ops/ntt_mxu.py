"""Matmul NTT over Fr: the Bailey 4-step with int8 digit products.

Counterpart of ``vote_saver_tpu/ops/ntt_mxu.py``, which the JAX package
runs for every domain of at least 2^12 on the TPU.  The transform is split
as ``n = n1 * n2``; each sub-DFT is a product against a constant DFT
matrix, the 255-bit elements cut into 37 unsigned 7-bit digits:

    X[o1 + n1*o2] = sum_{i2} W2[i2,o2] * T[o1,i2] * sum_{i1} W1[o1,i1] * x[i1*n2+i2]

The JAX package's digit convolution (one ``lax.conv_general_dilated``)
is here one int8 matrix product against a constant Toeplitz expansion of
the DFT matrix's digits,

    c[r, o, kc] = sum_i sum_{dw+dx=kc} W[o, i, dw] * X[r, i, dx]
                = (X_digits (R, i*37)) @ (T (i*37, o*73)),  T[(i, dx), (o, kc)] = W[o, i, kc - dx],

with exact int32 sums (|c| < 256 * 37 * 127^2 < 2^31).  The 73 digit
columns are folded mod r by a second int8 product against balanced base-256
digits of ``2^(7u + 32) mod r``, then a signed carry pass, one 32-bit
Montgomery word step that divides the 2^32 back out, and a conditional
subtract.  Coset factors and 1/n are folded into the constant matrices, as
there; the step-B twiddle between the two products is K1
(``FieldOps.mul``).

Both products take ``impl``: ``"int8"`` is ``torch._int_mm`` (int8 x int8
-> int32; the tensor cores on the card, and a CPU kernel too), ``"int64"``
an int64 ``torch.matmul``, the plain form the tests hold it against (CPU
only: the card has no integer matmul but ``_int_mm``).  Nothing here is a
TPU kernel: the JAX module is XLA, and its products are library calls in
the port.  ``products`` counts the int8 products by step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..params import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from . import limbs as lb
from .field_ops import fr_ops
from .hopper_field import _pack

DIGIT_BITS = 7
NDIGITS = 37  # ceil(256 / 7) covers any value < 2^256 (limbs span 256 bits)
NCOLS = 2 * NDIGITS - 1  # digit-product columns of one product
LIMB_BITS = 32  # the port's limbs, as the JAX CPU rig's: the fold is _fold_matrix(73, 32)
IMPLS = ("int8", "int64")
# int8 products on any device, by step: A and C contract the DFT, fold reduces mod r
products = {"step_a": 0, "step_c": 0, "fold": 0}


def reset_products() -> None:
    for k in products:
        products[k] = 0


# ---------------------------------------------------------------------------
# Host precompute (the JAX module's helpers, with the port's imports)
# ---------------------------------------------------------------------------


def _digits7_host(vals: np.ndarray) -> np.ndarray:
    """(..,) object ints -> (..., NDIGITS) int8 unsigned 7-bit digits."""
    flat = vals.reshape(-1)
    byts = np.frombuffer(
        b"".join(int(v).to_bytes(33, "little") for v in flat), dtype=np.uint8
    ).reshape(-1, 33)
    out = np.zeros((flat.size, NDIGITS), dtype=np.int8)
    for d in range(NDIGITS):
        s = DIGIT_BITS * d
        b, off = divmod(s, 8)
        v = (byts[:, b].astype(np.uint16) | (byts[:, b + 1].astype(np.uint16) << 8)) >> off
        out[:, d] = (v & 127).astype(np.int8)
    return out.reshape(vals.shape + (NDIGITS,))


def _balanced256_host(v: int, nd: int) -> list[int]:
    """v >= 0 -> nd balanced base-256 digits in [-128, 127]."""
    digs = []
    carry = 0
    for d in range(nd):
        t = ((v >> (8 * d)) & 255) + carry
        if t > 127:
            digs.append(t - 256)
            carry = 1
        else:
            digs.append(t)
            carry = 0
    assert carry == 0 and v < (1 << (8 * nd))
    return digs


@functools.cache
def _fold_matrix(ncols: int, shift_bits: int) -> np.ndarray:
    """(ncols*5, 33) int8: row (kc, t) holds balanced base-256 digits of
    2^(7*(kc+t)+shift) mod r — the mod-r fold of digit-product column
    (kc, t).  The 2^shift pre-scale is cancelled by the single Montgomery
    word-step in _fold_mod_r (shift = limb_bits)."""
    rows = []
    for kc in range(ncols):
        for t in range(5):
            rows.append(
                _balanced256_host(pow(2, DIGIT_BITS * (kc + t) + shift_bits, R), 33)
            )
    return np.asarray(rows, dtype=np.int8)


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


def _padded(a: np.ndarray) -> np.ndarray:
    """Zero rows and columns up to multiples of 8, as ``_int_mm`` wants K and N."""
    return np.pad(a, ((0, _pad8(a.shape[0]) - a.shape[0]), (0, _pad8(a.shape[1]) - a.shape[1])))


def _toeplitz_t_host(wd: np.ndarray) -> np.ndarray:
    """(o, i, NDIGITS) digits of W -> the transpose (o*73, i*37) of the
    int8 Toeplitz expansion T[(i, dx), (o, kc)] = W[o, i, kc - dx] (0
    outside 0..36), padded: on the card T is read column-major, the layout
    of cuBLASLt's int8 kernels (the row-major operand took 7x longer on an
    H100, ``chip_smoke.py``'s layout check)."""
    mo, mi, D = wd.shape
    tt = np.zeros((mo, NCOLS, mi, D), dtype=np.int8)
    wk = wd.transpose(0, 2, 1)  # (o, dw, i)
    for dx in range(D):
        tt[:, dx : dx + D, :, dx] = wk
    return _padded(tt.reshape(mo * NCOLS, mi * D))


# ---------------------------------------------------------------------------
# Device-side digit pipeline
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


@functools.cache
def _consts(name: str, device: torch.device) -> torch.Tensor:
    """The pipeline's constants on `device`, built once per device."""
    if name == "fold":  # (368, 40), column-major as T
        return torch.from_numpy(_padded(_fold_matrix(NCOLS, LIMB_BITS)).T.copy()).to(device).t()
    if name == "r":  # r's 32-bit limbs
        return torch.tensor([(R >> (32 * k)) & _M32 for k in range(8)], dtype=torch.int64, device=device)
    if name == "byte_shifts":  # byte t of a limb sits 8t bits up
        return torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
    # digit d = bits 7d .. 7d + 6: limb 7d // 32 ("limb") from bit 7d % 32 ("off"), the next limb above
    bits = [DIGIT_BITS * d for d in range(NDIGITS)]
    if name == "limb":
        return torch.tensor([b // LIMB_BITS for b in bits], device=device)
    if name == "off":
        return torch.tensor([b % LIMB_BITS for b in bits], device=device)
    raise KeyError(name)


def _digits7_device(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 Montgomery limbs (bit patterns) -> (..., NDIGITS)
    int8 digits in 0..127."""
    dev = x.device
    limb, off = _consts("limb", dev), _consts("off", dev)
    v = F.pad(x.to(torch.int64) & _M32, (0, 1))  # a zero limb above the top
    lo = v.index_select(-1, limb) >> off
    # only the next limb's low 7 bits can reach a digit (and stay in int64 when shifted up)
    hi = (v.index_select(-1, limb + 1) & 127) << (LIMB_BITS - off)
    return ((lo | hi) & 127).to(torch.int8)


def _mm(a: torch.Tensor, b: torch.Tensor, impl: str, step: str) -> torch.Tensor:
    """(M, K) int8 x (K', N) int8 constant (K' >= K, zero rows past K;
    column-major) -> (M, N) exact sums: int32 through ``_int_mm`` (which
    wants M > 16 and K, N multiples of 8), int64 through an int64 matmul."""
    M, K = a.shape
    if impl == "int64":
        return a.to(torch.int64) @ b[:K].to(torch.int64)
    if impl != "int8":
        raise ValueError(f"unknown product impl {impl!r}; expected one of {IMPLS}")
    a = F.pad(a, (0, b.shape[0] - K, 0, max(0, 17 - M)))
    products[step] += 1
    return torch._int_mm(a, b)[:M]


def _carry32(cols: torch.Tensor) -> list[torch.Tensor]:
    """Signed int64 columns (..., k) at 32-bit positions, |col| < 2^62 and
    a nonnegative value -> its k canonical 32-bit limbs (int64), one
    arithmetic-shift carry a position (the top carry is 0 for a value below
    2^(32k))."""
    out, carry = [], 0
    for k in range(cols.shape[-1]):
        t = cols[..., k] + carry
        out.append(t & _M32)
        carry = t >> 32
    return out


def _fold_mod_r(cols: torch.Tensor, impl: str = "int8") -> torch.Tensor:
    """Digit-product columns (..., NCOLS) int32, each in [0, 2^31), value
    V = sum_k cols_k 2^(7k) -> canonical (..., 8) int32 limbs of V mod r.

    The JAX package's pipeline, in its order: the 5-way 7-bit split into
    365 int8 pieces; one product against the fold matrix (pre-scaled by
    2^32) giving 33 signed base-256 coefficients; the signed carry pass and
    limb packing, here over the nine 32-bit positions of the 36 bytes (each
    limb's four coefficients summed first, |sum| < 2^47 in int64: the same
    canonical limbs as the byte pass); one 32-bit Montgomery word step,
    which divides the 2^32 back out and leaves a value below 2r; the
    conditional subtract of the port's Fr (``HalfField._csub``)."""
    lead = cols.shape[:-1]
    cols = cols.reshape(-1, NCOLS)
    M = cols.shape[0]
    parts = torch.stack([((cols >> (DIGIT_BITS * t)) & 127).to(torch.int8) for t in range(5)], dim=-1)
    fold = _consts("fold", cols.device)
    g = _mm(parts.reshape(M, NCOLS * 5), fold, impl, "fold")[:, :33].to(torch.int64)
    # signed carry pass: bytes 4k .. 4k+3 into limb k (36 bytes, the top three 0)
    g = F.pad(g, (0, 3)).reshape(M, 9, 4)
    v = _carry32((g << _consts("byte_shifts", g.device)).sum(dim=-1))
    # Montgomery word step: m = -V r^-1 mod 2^32 (the product split at 16
    # bits to stay in int64), then (V + m r) / 2^32, exact
    n0 = lb.FR.n0_inv
    m = (v[0] * (n0 & 0xFFFF) + (((v[0] * (n0 >> 16)) & 0xFFFF) << 16)) & _M32
    r = _consts("r", cols.device)
    m_lo, m_hi = (m & 0xFFFF)[:, None], (m >> 16)[:, None]
    hi = m_hi * r  # (M, 8), each < 2^48: its low 16 bits stay in limb k, the rest go up
    mr = m_lo * r + ((hi & 0xFFFF) << 16) + F.pad(hi >> 16, (1, 0))[:, :8]
    mr = F.pad(mr, (0, 1)) + F.pad((hi >> 16)[:, 7:], (8, 0))
    s = _carry32(torch.stack(v, dim=-1) + mr)[1:]  # limb 0 is 0; the value < 2r fills 8 limbs
    u = torch.stack(s, dim=-1)
    half = torch.stack((u & 0xFFFF, u >> 16), dim=-1).flatten(-2)
    return _pack(fr_ops().half._csub(F.pad(half, (0, 1)))).reshape(*lead, 8)


def _columns(t: torch.Tensor, x: torch.Tensor, impl: str, step: str) -> torch.Tensor:
    """x (N, m, 8) Montgomery limbs -> the digit-product columns (N, m',
    NCOLS) of W @ X, T the Toeplitz expansion of W (m' outputs)."""
    N, m, _L = x.shape
    c = _mm(_digits7_device(x).reshape(N, m * NDIGITS), t, impl, step)
    mo = c.shape[1] // NCOLS  # T's columns are o * 73, padded by fewer than 8
    return c[:, : mo * NCOLS].reshape(N, mo, NCOLS)


def _fr_matmul(t: torch.Tensor, x: torch.Tensor, impl: str, step: str) -> torch.Tensor:
    """Y = W @ X over Fr: x (N, m, 8) Montgomery limbs -> (N, m', 8)
    Montgomery limbs of sum_i W[o, i] X[i] (plain W times Montgomery X
    reduces mod r straight to Montgomery form)."""
    return _fold_mod_r(_columns(t, x, impl, step), impl)


# ---------------------------------------------------------------------------
# Transform plans
# ---------------------------------------------------------------------------


class MatmulNTTPlan:
    """One 4-step transform  out[o1 + n1*o2] =
    c * a^(o1 + n1*o2) * sum_i x[i] Omega^(i*(o1+n1*o2)) b^i
    with all scale factors folded into the three constant stages."""

    def __init__(self, n: int, omega: int, beta: int, alpha: int, c: int):
        assert n & (n - 1) == 0
        k = n.bit_length() - 1
        self.n = n
        self.n1 = 1 << (k // 2)
        self.n2 = n // self.n1
        n1, n2 = self.n1, self.n2
        assert max(n1, n2) <= 2048, "digit-column int32 headroom caps n at 4M"

        w_n1 = pow(omega, n2, R)  # primitive n1-th root
        w_n2 = pow(omega, n1, R)
        # Step A matrix: W1[o1, i1] = w_n1^(i1*o1) * beta^(n2*i1)
        i1 = np.arange(n1)
        b_pow = np.array([pow(beta, int(n2 * v), R) for v in i1], dtype=object)
        w1 = np.empty((n1, n1), dtype=object)
        w_n1_pows = [pow(w_n1, int(e), R) for e in range(n1)]
        for o in range(n1):
            for i in range(n1):
                w1[o, i] = w_n1_pows[(o * i) % n1] * b_pow[i] % R
        # Step B twiddle (transposed for the (.., i2, o1, L) layout):
        # T[i2, o1] = Omega^(i2*o1) * beta^i2 * c * alpha^o1
        t12 = np.empty((n2, n1), dtype=object)
        a_pow_o1 = [pow(alpha, int(v), R) for v in range(n1)]
        for i2 in range(n2):
            base = pow(omega, int(i2), R)
            acc = pow(beta, int(i2), R) * c % R
            for o in range(n1):
                t12[i2, o] = acc * a_pow_o1[o] % R
                acc = acc * base % R
        # Step C matrix, stored transposed: W2T[o2, i2] = w_n2^(i2*o2) * alpha^(n1*o2)
        w2t = np.empty((n2, n2), dtype=object)
        w_n2_pows = [pow(w_n2, int(e), R) for e in range(n2)]
        a_pow = [pow(alpha, int(n1 * v), R) for v in range(n2)]
        for o2 in range(n2):
            for i2 in range(n2):
                w2t[o2, i2] = w_n2_pows[(o2 * i2) % n2] * a_pow[o2] % R
        # digit d of each entry (the JAX plan keeps them flipped for its conv)
        self.w1d = _digits7_host(w1)
        self.w2td = _digits7_host(w2t)
        self.t12 = lb.ints_to_mont_limbs(t12, lb.FR)
        self._dev: dict = {}

    def table(self, name: str, device) -> torch.Tensor:
        """The step-A / step-C Toeplitz matrix ("a", "c") or the step-B
        twiddles ("t12") on `device`, built once per device (named by
        ``lb.device_of``: "cuda" and "cuda:0" are one)."""
        device = lb.device_of(device)
        key = (name, str(device))
        if key not in self._dev:
            if name == "t12":
                self._dev[key] = lb.to_tensor(self.t12, device)
            else:
                wd = self.w1d if name == "a" else self.w2td
                self._dev[key] = torch.from_numpy(_toeplitz_t_host(wd)).to(device).t()
        return self._dev[key]

    def steps_ab(self, xa: torch.Tensor, impl: str = "int8", rows: slice = slice(None)) -> torch.Tensor:
        """Steps A and B on columns: xa (bf, m, n1[i1], L), column i2 of
        `rows` at xa[:, i2 - rows.start] (x[i1*n2 + i2]) -> (bf, m, n1[o1],
        L): the contraction over i1, then the twiddle T[i2, o1]."""
        bf, m, n1, L = xa.shape
        y = _fr_matmul(self.table("a", xa.device), xa.reshape(bf * m, n1, L), impl, "step_a").reshape(bf, m, n1, L)
        # T stored as (n2[i2], n1[o1], L)
        return fr_ops().mul(y, self.table("t12", xa.device)[rows])

    def step_c(self, zc: torch.Tensor, impl: str = "int8") -> torch.Tensor:
        """Step C on rows: zc (bf, m, n2[i2], L) -> (bf, m, n2[o2], L), the
        contraction over i2."""
        bf, m, n2, L = zc.shape
        return _fr_matmul(self.table("c", zc.device), zc.reshape(bf * m, n2, L), impl, "step_c").reshape(bf, m, n2, L)

    def apply(self, x: torch.Tensor, impl: str = "int8") -> torch.Tensor:
        """x: (..., n, 8) Montgomery limbs -> transformed (..., n, 8)."""
        lead = x.shape[:-2]
        L = x.shape[-1]
        bf = 1
        for d in lead:
            bf *= d
        a = x.reshape(bf, self.n1, self.n2, L)
        z = self.steps_ab(a.transpose(1, 2), impl)
        r_ = self.step_c(z.transpose(1, 2), impl)
        # out[o1 + n1*o2] = R[o1, o2]
        return r_.transpose(1, 2).reshape(*lead, self.n, L)


@functools.cache
def get_plan(n: int, kind: str) -> MatmulNTTPlan:
    """kind: 'fwd' | 'fwd_coset' | 'inv' | 'inv_coset' (coset generator g;
    inverse includes the 1/n factor, matching ntt.NTT semantics)."""
    omega = pow(FR_ROOT_OF_UNITY, (1 << FR_TWO_ADICITY) // n, R)
    g = FR_GENERATOR
    n_inv = pow(n, R - 2, R)
    if kind == "fwd":
        return MatmulNTTPlan(n, omega, 1, 1, 1)
    if kind == "fwd_coset":
        return MatmulNTTPlan(n, omega, g, 1, 1)
    om_inv = pow(omega, R - 2, R)
    if kind == "inv":
        return MatmulNTTPlan(n, om_inv, 1, 1, n_inv)
    if kind == "inv_coset":
        return MatmulNTTPlan(n, om_inv, 1, pow(g, R - 2, R), n_inv)
    raise ValueError(kind)
