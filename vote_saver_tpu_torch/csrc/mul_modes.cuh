// The three multiplier modes of the port's Montgomery multiply.
//
// Replaces the VSTPU_MUL modes of vote_saver_tpu/ops/pallas_field.py
// (selected at l.274-283), as explicit types instead of an environment
// variable:
//
//   MulLoop  <- FqEmitLoop.mul (l.227-271), the default there and here: CIOS,
//               the product and the reduction interleaved limb by limb (the
//               body is field.cuh's mul);
//   MulV1    <- FqEmit.mul (l.115-139): separated operand scanning, the full
//               2L-word product first, then L reduction steps, unrolled;
//   MulFold  <- FqEmitFold (l.187-224, with ops/fold_mul.py): digit-column
//               products as exact fp32 FMAs, the whole reduction as one
//               product with a constant matrix, two 16-bit Montgomery word
//               steps and a conditional subtract.
//
// A mode is a type with `template <class P> static Fp<P> mul(a, b)` and
// the traits of ModeTraits below.  The kernels take it as a template
// parameter, and every kernel of the
// curve_kernels.cuh / add_team.cuh templates is instantiated in all three
// modes: loop in kernels.cu, add_distinct.cu and add_team.cu, v1 in
// curve_v1.cu, fold in curve_fold.cu; K1 in mont_mul_modes.cu (v1, fold)
// beside kernels.cu, and the probes of micro.cu in the modes they compare.
// The G1 curve kernels take Called<M>, the mode's body called out of line
// (field.cuh says why).  All three return the same canonical value, limb
// for limb.
//
// What bounds each: loop and v1, the 2L^2 + L 32x32->64 multiply-adds (Fq:
// 300, Fr: 136) plus their carry chains.  Fold, per Fq multiply, 2,304 fp32
// FMAs for the 48 x 48 digit products and the fold: 285 x 52 byte products,
// done here as 72 x 52 dp4a (four rows of the matrix per instruction), one
// lane at a time with the matrix in __constant__ memory (every lane of a
// warp reads the same word at once, so the reads broadcast).  That per-lane
// fold is K1's (mont_mul_modes.cu).  The probes K7 and K10 run the fold
// product the way the TPU kernel did (fold_mul.fold_columns inside
// FqEmitFold: one matmul against the constant matrix) on the int8 tensor
// cores: fold_mma.cuh, a warp's 32 lanes as one tile of 126 mma.sync, so
// the lane keeps only the fp32 digit columns, which then bound it (2,304
// FMAs a multiply at the issue rate), and MulFold's steps 1-3 and 5-6
// around the product; fold_finish below is the tail both forms share.  The
// fold unit's bucket scans, suffix rounds and doublings in G1 and G2, its
// G1 complete add and its Fr inversion chain (curve_fold.cu) take the same
// tensor-core fold as a mode of its own, MulFoldMma in Fq and
// MulFoldMmaOf<FrParams> in Fr (fold_mma.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

// What a kernel must know of a mode besides its multiply:
//   kConverged           every thread of a warp must reach each multiply
//                        together (mma.sync and ldmatrix are .sync.aligned),
//                        so the kernel takes its converged form
//                        (curve_kernels.cuh);
//   smem_bytes(threads)  the dynamic shared memory a block of `threads` needs;
//   prologue()           what every thread of a block runs once, before its
//                        first multiply and before any thread exits.
// false, 0 and nothing for MulLoop, MulV1 and MulFold; the tensor-core fold
// MulFoldMmaOf<P> (fold_mma.cuh) sets all three.
struct ModeTraits {
  static constexpr bool kConverged = false;
  static constexpr int smem_bytes(int) { return 0; }
  __device__ static __forceinline__ void prologue() {}
};

struct MulLoop : ModeTraits {
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    return ::mul(a, b);
  }
};

struct MulV1 : ModeTraits {
  // SOS: t = a * b in 2L words, then L steps t += m_i N 2^(32 i); the carry
  // out of word i + L rides in `extra` to the next step's word i + L + 1.
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    constexpr int L = P::L;
    uint32_t t[2 * L];
#pragma unroll
    for (int j = 0; j < 2 * L; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
        t[i + j] = (uint32_t)s;
        c = s >> 32;
      }
      t[i + L] = (uint32_t)c;
    }
    uint32_t extra = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t m = t[i] * P::N0INV;
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint64_t s = (uint64_t)m * P::n(j) + t[i + j] + c;
        t[i + j] = (uint32_t)s;
        c = s >> 32;
      }
      const uint64_t s = (uint64_t)t[i + L] + c + extra;
      t[i + L] = (uint32_t)s;
      extra = (uint32_t)(s >> 32);
    }
    return csub<P>(t + L, extra);
  }
};

// ---------------------------------------------------------------------------
// The fold (MulFold): geometry of ops/fold_mul.plan and the packed matrix.
// ---------------------------------------------------------------------------

template <class P>
struct FoldGeom;

template <>
struct FoldGeom<FqParams> {
  static constexpr int ND = 48, NCOLS = 95, ROWS = 285, GROUPS = 72, NBYTES = 52;
};

template <>
struct FoldGeom<FrParams> {
  static constexpr int ND = 32, NCOLS = 63, ROWS = 189, GROUPS = 48, NBYTES = 36;
};

// ops/fold_mul.packed_matrix: word [g][d] holds, in byte k, the matrix entry
// of row 4g + k and output byte d.  Every translation unit has its own copy,
// which fold_upload fills once per library and card (hopper_field's
// upload_fold_matrix, before the unit's first fold launch).
__constant__ int32_t kFoldFq[FoldGeom<FqParams>::GROUPS * FoldGeom<FqParams>::NBYTES];
__constant__ int32_t kFoldFr[FoldGeom<FrParams>::GROUPS * FoldGeom<FrParams>::NBYTES];

template <class P>
__device__ __forceinline__ int32_t fold_word(int g, int d);

template <>
__device__ __forceinline__ int32_t fold_word<FqParams>(int g, int d) {
  return kFoldFq[g * FoldGeom<FqParams>::NBYTES + d];
}

template <>
__device__ __forceinline__ int32_t fold_word<FrParams>(int g, int d) {
  return kFoldFr[g * FoldGeom<FrParams>::NBYTES + d];
}

// Host: copy the packed matrix of field 0 (Fq) or 1 (Fr) into this
// translation unit's __constant__ memory; a cudaError_t, 0 on success.
static inline int fold_upload(int field, const void* words, long long nwords) {
  const size_t bytes = (size_t)nwords * sizeof(int32_t);
  if (field == 0) {
    if (bytes != sizeof(kFoldFq)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(kFoldFq, words, bytes);
  }
  if (bytes != sizeof(kFoldFr)) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(kFoldFr, words, bytes);
}

// d = c + sum_k a.byte_k (unsigned) * b.byte_k (signed)
__device__ __forceinline__ int32_t dp4a_us(uint32_t a, int32_t b, int32_t c) {
  int32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 16-bit word k of N (the word steps run on the JAX layout's 16-bit words)
template <class P>
__device__ __forceinline__ uint32_t n16(int k) {
  return (P::n(k / 2) >> (16 * (k % 2))) & 0xFFFFu;
}

// Steps 5-6 of the fold, from the signed byte coefficients g[] of the
// folded value (|g| < 2^24): the byte carry pass, two 16-bit Montgomery
// word steps that divide the 2^32 pre-scale back out, the conditional
// subtract.
template <class P>
__device__ __forceinline__ Fp<P> fold_finish(const int32_t (&g)[FoldGeom<P>::NBYTES]) {
  using G = FoldGeom<P>;
  constexpr int L16 = 2 * P::L;
  constexpr int NL = (G::NBYTES + 1) / 2;
  // 5. byte carry pass (the value is nonnegative), bytes -> 16-bit words
  uint32_t w[NL];
  int32_t carry = 0;
#pragma unroll
  for (int d = 0; d < G::NBYTES; ++d) {
    const int32_t t = g[d] + carry;
    const uint32_t byte = (uint32_t)t & 0xFFu;
    carry = t >> 8;  // arithmetic shift
    if (d % 2 == 0) {
      w[d / 2] = byte;
    } else {
      w[d / 2] |= byte << 8;
    }
  }
  //    two Montgomery word steps divide the 2^32 pre-scale back out
  constexpr uint32_t kN0Inv16 = P::N0INV & 0xFFFFu;
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    const uint32_t m = (w[0] * kN0Inv16) & 0xFFFFu;
    uint32_t c = (w[0] + m * n16<P>(0)) >> 16;
#pragma unroll
    for (int k = 1; k < NL; ++k) {
      uint32_t t = w[k] + c;
      if (k < L16) t += m * n16<P>(k);
      w[k - 1] = t & 0xFFFFu;
      c = t >> 16;
    }
    w[NL - 1] = c;
  }
  // 6. value < 2N in L16 + 1 words -> canonical
  uint32_t t32[P::L];
#pragma unroll
  for (int j = 0; j < P::L; ++j) t32[j] = w[2 * j] | (w[2 * j + 1] << 16);
  return csub<P>(t32, w[L16]);
}

template <class P>
__device__ __noinline__ Fp<P> mul_fold(const Fp<P> a, const Fp<P> b) {
  using G = FoldGeom<P>;
  // 1. digits, exact in fp32
  float da[G::ND], db[G::ND];
#pragma unroll
  for (int k = 0; k < G::ND; ++k) {
    da[k] = (float)((a.v[k / 4] >> (8 * (k % 4))) & 0xFFu);
    db[k] = (float)((b.v[k / 4] >> (8 * (k % 4))) & 0xFFu);
  }
  // 2.-4. column c (< 2^22, exact fp32 FMAs) -> pieces of rows 3c..3c+2,
  // four rows per dp4a into the signed byte coefficients g[d] (|g| < 2^24)
  int32_t g[G::NBYTES];
#pragma unroll
  for (int d = 0; d < G::NBYTES; ++d) g[d] = 0;
  uint32_t pieces = 0;
#pragma unroll
  for (int c = 0; c < G::NCOLS; ++c) {
    float col = 0.f;
#pragma unroll
    for (int i = 0; i < G::ND; ++i) {
      if (c - i >= 0 && c - i < G::ND) col = fmaf(da[i], db[c - i], col);
    }
    const uint32_t v = (uint32_t)col;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int r = 3 * c + t;
      pieces |= ((v >> (8 * t)) & 0xFFu) << (8 * (r % 4));
      if (r % 4 == 3 || r == G::ROWS - 1) {
#pragma unroll
        for (int d = 0; d < G::NBYTES; ++d) g[d] = dp4a_us(pieces, fold_word<P>(r / 4, d), g[d]);
        pieces = 0;
      }
    }
  }
  return fold_finish<P>(g);
}

struct MulFold : ModeTraits {
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    return mul_fold<P>(a, b);
  }
};

// Mode M's body as a real call (one copy per kernel) instead of inlined at
// every multiply: the G1 curve kernels' form in every mode (field.cuh says
// why), as G2's Karatsuba already calls its Fq multiply (fq_mul_call
// below).  Called<MulLoop> is the loop instances' form; in fold the call
// wraps mul_fold's own.  Same limbs and traits as M.
template <class M, class P>
__device__ __noinline__ Fp<P> mul_called(const Fp<P> a, const Fp<P> b) {
  return M::mul(a, b);
}

template <class M>
struct Called {
  static constexpr bool kConverged = M::kConverged;
  static constexpr int smem_bytes(int threads) { return M::smem_bytes(threads); }
  __device__ static __forceinline__ void prologue() { M::prologue(); }
  // M's warp tiles, where M has them (MulFoldMma: jac_add_warps, curve.cuh)
  __device__ static __forceinline__ uint8_t* warp_tile(int w) { return M::warp_tile(w); }
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    return mul_called<M, P>(a, b);
  }
};

// ---------------------------------------------------------------------------
// Multiplies over a mode: fmul<M> / fsq<M> on Fp<P> and on Fq2.
// ---------------------------------------------------------------------------

template <class M, class P>
__device__ __forceinline__ Fp<P> fmul(const Fp<P>& a, const Fp<P>& b) {
  return M::mul(a, b);
}

template <class M, class P>
__device__ __forceinline__ Fp<P> fsq(const Fp<P>& a) {
  return M::mul(a, a);
}

// Fq2 = Fq[u]/(u^2 + 1), exactly as Fq2Emit: Karatsuba mul (3 Fq muls),
// square as (a0 + a1)(a0 - a1), 2 a0 a1 (2 Fq muls).  The Fq multiply is a
// real call here (one copy per kernel): inlining all ~100 of a G2 complete
// add's multiplies made a 68 s ptxas compile and 1.7 KB of spills.
template <class M>
__device__ __noinline__ Fq fq_mul_call(const Fq a, const Fq b) {
  return M::mul(a, b);
}

template <class M>
__device__ __forceinline__ Fq2 fmul(const Fq2& a, const Fq2& b) {
  const Fq t0 = fq_mul_call<M>(a.c0, b.c0);
  const Fq t1 = fq_mul_call<M>(a.c1, b.c1);
  const Fq t2 = fq_mul_call<M>(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(t2, add(t0, t1))};
}

template <class M>
__device__ __forceinline__ Fq2 fsq(const Fq2& a) {
  const Fq t0 = fq_mul_call<M>(add(a.c0, a.c1), sub(a.c0, a.c1));
  const Fq t1 = fq_mul_call<M>(a.c0, a.c1);
  return {t0, add(t1, t1)};
}
