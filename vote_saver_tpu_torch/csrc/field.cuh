// Montgomery field arithmetic on 32-bit limbs for Hopper (sm_90a).
//
// Replaces: the in-kernel emitters of vote_saver_tpu/ops/pallas_field.py —
// FqEmitLoop.mul (loop-CIOS Montgomery multiply, l.245-271), the FqEmit
// helpers _ripple/_csub_n/add/sub/is_zero/select/one_like (l.83-184) and the
// Fq2 add/sub/select of Fq2Emit (l.301-339; its Karatsuba multiply is in
// mul_modes.cuh, over the multiplier mode).
//
// Layout: an element is L little-endian uint32 limbs in Montgomery form,
// R = 2^(32L): Fq L = 12 (R = 2^384), Fr L = 8 (R = 2^256) — the same values
// as the JAX package's 16-bit layout, whose R is identical.  Fq2 elements
// are (c0, c1) with c0 first, as the (B, 2, L) tensors store them.
//
// What bounds it: integer multiply throughput.  One Fq CIOS multiply is
// 144 (a_i * b_j) + 144 (m * N_j) 32x32->64-bit multiply-adds plus the carry
// chains; an add or sub is ~2L 32-bit add-with-carry.  Every op keeps all
// limbs in registers (one thread per lane), so memory traffic is only the
// kernel's inputs and outputs.
//
// What the design does about it: CIOS interleaves the product and the
// reduction so the running state is L + 2 registers and one final
// conditional subtract makes the result canonical (< N) — the same
// canonical value the plain PyTorch twin and the Pallas emitters produce,
// so all three agree limb for limb.  The 64-bit accumulator form lets nvcc
// pick IMAD.WIDE / IADD3 carry sequences; hand-scheduled PTX carry chains
// (mad.lo.cc / madc.hi) are left to a later tuning change.
//
// Inlined or called: `mul` is inlined where it is used, except in the curve
// kernels.  There each Fq multiply is a call of one out-of-line copy
// (mul_modes.cuh: Called<M> in the G1 kernels K2, its scan, K3, its shift
// form and K4, and in every G1 kernel of the v1 and fold modes;
// fq_mul_call inside the Fq2 multiply of every G2 kernel).  Inlined, a G1
// formula is 7-23 copies of a 300 multiply-add body: the call form ran
// 0.45-0.6x the inlined form's time in each of those kernels on the card,
// at 16 lanes and at 248,832 (PERF.md, Findings), with fewer registers (K3
// 254 -> 234, the scan 244 -> 198) and half the ptxas time.  The loop
// instances of the distinct adds K3d and K5/K6 (add_distinct.cu), K1 and
// its inversion chain keep the inlined form.
#pragma once

#include <cstdint>

__constant__ uint32_t kFqN[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t kFqOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
__constant__ uint32_t kFrN[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
__constant__ uint32_t kFrOne[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// N - 2, the Fermat inversion's exponent (381 bits, 229 set in Fq; 255 and
// 164 in Fr)
__constant__ uint32_t kFqNm2[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t kFrNm2[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

struct FqParams {
  static constexpr int L = 12;
  static constexpr uint32_t N0INV = 0xfffcfffdu;  // -N^-1 mod 2^32
  static constexpr int NM2_BITS = 381;
  __device__ static __forceinline__ uint32_t n(int i) { return kFqN[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kFqOne[i]; }
  __device__ static __forceinline__ uint32_t nm2(int i) { return kFqNm2[i]; }
};

struct FrParams {
  static constexpr int L = 8;
  static constexpr uint32_t N0INV = 0xffffffffu;
  static constexpr int NM2_BITS = 255;
  __device__ static __forceinline__ uint32_t n(int i) { return kFrN[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kFrOne[i]; }
  __device__ static __forceinline__ uint32_t nm2(int i) { return kFrNm2[i]; }
};

template <class P>
struct Fp {
  uint32_t v[P::L];
};

using Fq = Fp<FqParams>;
using Fr = Fp<FrParams>;

struct Fq2 {
  Fq c0, c1;
};

// t[0..L) with top word `top`, value < 2N  ->  canonical value < N.
template <class P>
__device__ __forceinline__ Fp<P> csub(const uint32_t* t, uint32_t top) {
  constexpr int L = P::L;
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t s = (uint64_t)t[j] - P::n(j) - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (borrow == 0) || (top != 0);  // value >= N: keep the difference
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = ge ? d.v[j] : t[j];
  return r;
}

// CIOS Montgomery product a * b * R^-1 mod N for canonical a, b: the body
// of the `loop` multiplier mode (MulLoop in mul_modes.cuh), every kernel's
// default.
template <class P>
__device__ __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
  constexpr int L = P::L;
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * P::N0INV;
    s = (uint64_t)m * P::n(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)m * P::n(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }
  return csub<P>(t, t[L]);
}

template <class P>
__device__ __forceinline__ Fp<P> sq(const Fp<P>& a) {
  return mul(a, a);
}

template <class P>
__device__ __forceinline__ Fp<P> add(const Fp<P>& a, const Fp<P>& b) {
  constexpr int L = P::L;
  uint32_t s[L];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t x = (uint64_t)a.v[j] + b.v[j] + c;
    s[j] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
  return csub<P>(s, c);
}

template <class P>
__device__ __forceinline__ Fp<P> sub(const Fp<P>& a, const Fp<P>& b) {
  constexpr int L = P::L;
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t x = (uint64_t)a.v[j] - b.v[j] - borrow;
    d.v[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 32) & 1u;
  }
  // on borrow add N back (the carry out of the top limb cancels the borrow)
  Fp<P> f;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t x = (uint64_t)d.v[j] + P::n(j) + c;
    f.v[j] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = borrow ? f.v[j] : d.v[j];
  return r;
}

template <class P>
__device__ __forceinline__ bool is_zero(const Fp<P>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < P::L; ++j) acc |= a.v[j];
  return acc == 0;
}

template <class P>
__device__ __forceinline__ Fp<P> sel(bool c, const Fp<P>& a, const Fp<P>& b) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < P::L; ++j) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

template <class E>
__device__ __forceinline__ E zero_of();
template <class E>
__device__ __forceinline__ E one_of();

template <>
__device__ __forceinline__ Fq zero_of<Fq>() {
  Fq r;
#pragma unroll
  for (int j = 0; j < FqParams::L; ++j) r.v[j] = 0;
  return r;
}

template <>
__device__ __forceinline__ Fq one_of<Fq>() {
  Fq r;
#pragma unroll
  for (int j = 0; j < FqParams::L; ++j) r.v[j] = FqParams::one(j);
  return r;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1): add, sub, tests and selects here; its multiply and
// square take the multiplier mode (fmul<M> / fsq<M> in mul_modes.cuh).
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fq2 add(const Fq2& a, const Fq2& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 sub(const Fq2& a, const Fq2& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

__device__ __forceinline__ bool is_zero(const Fq2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

__device__ __forceinline__ Fq2 sel(bool c, const Fq2& a, const Fq2& b) {
  return {sel(c, a.c0, b.c0), sel(c, a.c1, b.c1)};
}

template <>
__device__ __forceinline__ Fq2 zero_of<Fq2>() {
  return {zero_of<Fq>(), zero_of<Fq>()};
}

template <>
__device__ __forceinline__ Fq2 one_of<Fq2>() {
  return {one_of<Fq>(), zero_of<Fq>()};
}

// ---------------------------------------------------------------------------
// Global-memory access: lane i of a (B, L) or (B, 2, L) int32 tensor.
// ---------------------------------------------------------------------------

template <class P>
__device__ __forceinline__ void load(Fp<P>& x, const uint32_t* base, int64_t i) {
  const uint32_t* p = base + i * P::L;
#pragma unroll
  for (int j = 0; j < P::L; ++j) x.v[j] = p[j];
}

template <class P>
__device__ __forceinline__ void store(uint32_t* base, int64_t i, const Fp<P>& x) {
  uint32_t* p = base + i * P::L;
#pragma unroll
  for (int j = 0; j < P::L; ++j) p[j] = x.v[j];
}

__device__ __forceinline__ void load(Fq2& x, const uint32_t* base, int64_t i) {
  load(x.c0, base, 2 * i);
  load(x.c1, base, 2 * i + 1);
}

// Read-only loads (ld.global.nc) of a table that stays in L2 for the whole
// kernel, such as the bucket scan's affine points.
template <class P>
__device__ __forceinline__ void load_ro(Fp<P>& x, const uint32_t* __restrict__ base, int64_t i) {
  const uint32_t* p = base + i * P::L;
#pragma unroll
  for (int j = 0; j < P::L; ++j) x.v[j] = __ldg(p + j);
}

__device__ __forceinline__ void load_ro(Fq2& x, const uint32_t* __restrict__ base, int64_t i) {
  load_ro(x.c0, base, 2 * i);
  load_ro(x.c1, base, 2 * i + 1);
}

__device__ __forceinline__ void store(uint32_t* base, int64_t i, const Fq2& x) {
  store(base, 2 * i, x.c0);
  store(base, 2 * i + 1, x.c1);
}
