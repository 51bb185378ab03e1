"""Protocol-wide curve and field constants for the TPU-native SAVER voting stack.

Everything in the stack is typed against BLS12-381 (pairing curve) and JubJub
(embedded twisted-Edwards curve over BLS12-381's scalar field), mirroring the
reference's ``encrypted_input_policy`` (reference: bin/cli/include/nil/
vote_saver/common.hpp:147-166) — but re-derived from the curve standards, not
translated from crypto3.

Limb layout for device (JAX/Pallas) arithmetic: b-bit limbs stored in uint32,
chosen so that limb products fit exactly in uint32 and column sums of lo/hi
product halves fit exactly in float32's 24-bit integer range (so anti-diagonal
accumulation can ride the MXU).
"""

from __future__ import annotations

import dataclasses
import functools

# --------------------------------------------------------------------------
# BLS12-381
# --------------------------------------------------------------------------

# Base field modulus q (381 bits).
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus r (255 bits) — also JubJub's base field.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative): q and r are the standard polynomials in x.
BLS_X = -0xD201000000010000

# Curve equations: E/Fq: y^2 = x^3 + 4 ; E'/Fq2: y^2 = x^3 + 4(u+1)  (M-twist)
B_G1 = 4
B_G2 = (4, 4)  # 4*(u+1) as an Fq2 element (c0, c1)

# Standard generators.
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# Multiplicative generator of Fr* and the 2-adicity of r-1 (for NTT domains).
FR_GENERATOR = 7
FR_TWO_ADICITY = 32
# Primitive 2^32-th root of unity in Fr.
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# --------------------------------------------------------------------------
# JubJub (twisted Edwards over Fr):  -x^2 + y^2 = 1 + d x^2 y^2
# --------------------------------------------------------------------------

JUBJUB_A = R - 1  # a = -1
JUBJUB_D = (-10240 * pow(10241, R - 2, R)) % R
# Order of the prime subgroup; the full group order is 8 * JUBJUB_RS.
JUBJUB_RS = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
JUBJUB_COFACTOR = 8

# --------------------------------------------------------------------------
# Protocol policy (reference: common.hpp:147-166)
# --------------------------------------------------------------------------

MSG_SIZE = 25          # number of vote candidates (one-hot ballot)
SECRET_KEY_BITS = 255  # = Pedersen digest bits = bits of an Fr x-coordinate
PUBLIC_KEY_BITS = 255
DIGEST_BITS = 255
MERKLE_ARITY = 2
DEFAULT_EID_BITS = 64
DEFAULT_TREE_DEPTH = 2
# Packing chunk size: field bits - 1 (reference: common.hpp:861)
CHUNK_SIZE = 254

# Pedersen hash personalisation (our spec — see docs/HASH_SPEC.md):
PEDERSEN_WINDOW_BITS = 3
PEDERSEN_WINDOWS_PER_SEGMENT = 63
PEDERSEN_SPACING_BITS = 4  # window w within a segment uses base 2^(4w) * I_j
GROUP_HASH_TAG = b"VoteSaverTPU_PedersenGens"

# --------------------------------------------------------------------------
# Limb layouts for device arithmetic
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Montgomery fixed-limb layout of a prime field for uint32 device math."""

    name: str
    modulus: int
    limb_bits: int
    num_limbs: int

    @property
    def mask(self) -> int:
        return (1 << self.limb_bits) - 1

    @property
    def mont_r(self) -> int:
        return 1 << (self.limb_bits * self.num_limbs)

    @property
    def mont_r_inv(self) -> int:
        return pow(self.mont_r, self.modulus - 2, self.modulus)

    @property
    def mont_r2(self) -> int:
        return (self.mont_r * self.mont_r) % self.modulus

    @property
    def n0_inv(self) -> int:
        """-modulus^{-1} mod 2^limb_bits (Montgomery reduction constant)."""
        return (-pow(self.modulus, -1, 1 << self.limb_bits)) % (1 << self.limb_bits)

    def to_limbs(self, x: int) -> list[int]:
        return [(x >> (self.limb_bits * i)) & self.mask for i in range(self.num_limbs)]

    def from_limbs(self, limbs) -> int:
        return sum(int(l) << (self.limb_bits * i) for i, l in enumerate(limbs))

    def to_mont(self, x: int) -> int:
        return (x * self.mont_r) % self.modulus

    def from_mont(self, x: int) -> int:
        return (x * self.mont_r_inv) % self.modulus


def _limb_bits() -> int:
    """16-bit limbs in uint32 (TPU: no native 64-bit ints, f32-matmul exact
    accumulation) or 32-bit limbs in uint64 (CPU tests: native width, f64
    matmuls — ~10x faster there).  Set VSTPU_LIMB_BITS before import."""
    import os

    return int(os.environ.get("VSTPU_LIMB_BITS", "16"))


@functools.cache
def fr_spec() -> FieldSpec:
    b = _limb_bits()
    return FieldSpec("fr", R, b, 256 // b)


@functools.cache
def fq_spec() -> FieldSpec:
    b = _limb_bits()
    return FieldSpec("fq", Q, b, 384 // b)
