// The loop and v1 Montgomery multiplies as PTX carry chains: the bodies of
// the multiply probes K7 and K8 in those modes.
//
// Replaces (in the probes only): field.cuh's mul (MulLoop, CIOS) and
// mul_modes.cuh's MulV1 (SOS), which stay as every curve kernel's and K1's
// multiply and as the probes' yardstick instances (micro.cu).  Those write
// each multiply-add as (uint64_t)a_i * b_j + t_j + c; nvcc lowers that to
// an IMAD.WIDE.U32 and separate 32-bit adds that split the 64-bit carry
// back out, and those adds compete with the multiplies for issue slots.
//
// What bounds it: the 2L^2 + L 32x32->64 multiply-adds (Fq: 300), each a
// low and a high 32-bit multiply-add.  What the design does about it: every
// row of partial products is one unbroken run of mad.lo.cc / madc.hi.cc
// with the carry in the condition-code flag, so a multiply-add costs its
// two multiply instructions and nothing else.  The even- and odd-index
// partial products of a row go into two accumulators E and O, the value
// being E + W O (W = 2^32): a_i b_j with i + j even lands on a word pair
// (2p, 2p + 1) of E, with i + j odd on a pair of O, so neither run overlaps
// itself.  That is the scheme of Supranational's sppark (ff/mont_t.cuh),
// written anew here for the port's limbs and bounds.
//
//   MulLoopPtx  CIOS, the rows over a's words and each row's reduction
//               interleaved (as field.cuh's mul): after row i's reduction
//               word 0 of E is 0, and the division by W is the arrays
//               trading places, E's words 2.. shifted into O's registers by
//               the next row's own O run.  The value stays below 2N, since
//               b < N (a may be any 384-bit value).
//   MulV1Ptx    SOS, as MulV1: the 2L-word product first (E and O over 2L
//               words, merged once), then L reduction rows on its low half
//               in the same shifting form, then its high half added.
//
// Both return the canonical value for a < 2^(32L) and b < N: the value
// before the final subtract is (a b + M N) / R < (R N + R N) / R = 2N.  No
// run can carry out of its top word: each array, times its weight, is at
// most the whole value, which stays below W^(L+1) (Fq's N < 2^381).
//
// The chains hold the carry in one flag, so each run is written in order.
// ptxas fuses a run's low / high pair into one IMAD.WIDE.U32.X with the
// carries in predicate registers, and schedules the independent runs (E's
// and O's of a row, the kernel's other chains) around each other: a loop
// multiply is 274 wide and 31 other IMADs against the bound's 300
// multiply-adds (cuobjdump, PERF.md).
//
// Compiled by anything but nvcc (the CPU tests, with g++), the primitives
// below model the same instructions on a carry variable, so the rows run
// the same arithmetic where there is no card.
#pragma once

#include <cstdint>

#include "mul_modes.cuh"

namespace ptx {

#ifdef __CUDACC__

__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }

#define VS_PTX3(fn, op)                                                            \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b, uint32_t c) {     \
    uint32_t d;                                                                    \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));        \
    return d;                                                                      \
  }
#define VS_PTX2(fn, op)                                                            \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {                 \
    uint32_t d;                                                                    \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));                    \
    return d;                                                                      \
  }

VS_PTX3(mad_lo_cc, "mad.lo.cc.u32")
VS_PTX3(madc_lo_cc, "madc.lo.cc.u32")
VS_PTX3(madc_hi_cc, "madc.hi.cc.u32")
VS_PTX3(madc_hi, "madc.hi.u32")
VS_PTX2(add_cc, "add.cc.u32")
VS_PTX2(addc_cc, "addc.cc.u32")
VS_PTX2(addc, "addc.u32")
VS_PTX2(sub_cc, "sub.cc.u32")
VS_PTX2(subc_cc, "subc.cc.u32")
VS_PTX2(subc, "subc.u32")

#undef VS_PTX3
#undef VS_PTX2

#else  // the host model: CC.CF as a variable

inline uint32_t& carry_flag() {
  static uint32_t cf = 0;
  return cf;
}

inline uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }

inline uint32_t set_cf(uint64_t s) {
  carry_flag() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}

inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return set_cf((uint64_t)mul_lo(a, b) + c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)mul_lo(a, b) + c + carry_flag());
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)mul_hi(a, b) + c + carry_flag());
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return mul_hi(a, b) + c + carry_flag(); }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return set_cf((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return set_cf((uint64_t)a + b + carry_flag()); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + carry_flag(); }
// the borrow is CF as PTX sets it: 1 when the difference is negative
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return set_cf(((uint64_t)a - b) & 0x1FFFFFFFFull); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return set_cf(((uint64_t)a - b - carry_flag()) & 0x1FFFFFFFFull);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - carry_flag(); }

#endif  // __CUDACC__

// The modulus split by index parity: ne = N_0, N_2, ...; no = N_1, N_3, ...
// (the odd words land one word up, in O)
template <class P>
struct Split {
  uint32_t ne[P::L / 2], no[P::L / 2];
  __device__ __forceinline__ Split() {
#pragma unroll
    for (int p = 0; p < P::L / 2; ++p) {
      ne[p] = P::n(2 * p);
      no[p] = P::n(2 * p + 1);
    }
  }
};

// the same split of an element's words
template <int L>
__device__ __forceinline__ void split(const uint32_t* a, uint32_t* ev, uint32_t* od) {
#pragma unroll
  for (int p = 0; p < L / 2; ++p) {
    ev[p] = a[2 * p];
    od[p] = a[2 * p + 1];
  }
}

// e[0..L) += x * (v[0], v[1], ...) on word pairs (2p, 2p + 1), v[p] being
// the multiplicand's p-th even (or odd) word: one run with the carry left
// in CF (FIRST: e's words are 0 and the products are set, not added)
template <int L, bool FIRST>
__device__ __forceinline__ void row(uint32_t* e, uint32_t x, const uint32_t* v) {
#pragma unroll
  for (int p = 0; p < L / 2; ++p) {
    if (FIRST) {
      e[2 * p] = mul_lo(x, v[p]);
      e[2 * p + 1] = mul_hi(x, v[p]);
    } else {
      e[2 * p] = p == 0 ? mad_lo_cc(x, v[0], e[0]) : madc_lo_cc(x, v[p], e[2 * p]);
      e[2 * p + 1] = madc_hi_cc(x, v[p], e[2 * p + 1]);
    }
  }
}

// e[j] = e[j + 2] + x * v on pairs, the carry into word 0 from CF: the
// division by W that moves E's words 2.. into O's registers, fused with the
// row's O run (words past L are 0; nothing carries out of the top)
template <int L>
__device__ __forceinline__ void row_shift(uint32_t* e, uint32_t x, const uint32_t* v) {
#pragma unroll
  for (int p = 0; p < L / 2; ++p) {
    const uint32_t lo = 2 * p + 2 < L ? e[2 * p + 2] : 0u;
    const uint32_t hi = 2 * p + 3 < L ? e[2 * p + 3] : 0u;
    e[2 * p] = madc_lo_cc(x, v[p], lo);
    e[2 * p + 1] = p + 1 < L / 2 ? madc_hi_cc(x, v[p], hi) : madc_hi(x, v[p], hi);
  }
}

// t[0..L) (a value < 2N) -> canonical: one subtract run, one select
template <class P>
__device__ __forceinline__ Fp<P> csub(const uint32_t* t) {
  constexpr int L = P::L;
  uint32_t d[L];
  d[0] = sub_cc(t[0], P::n(0));
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(t[j], P::n(j));
  const bool lt = subc(0u, 0u) != 0u;  // the run borrowed: t < N
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = lt ? t[j] : d[j];
  return r;
}

// One CIOS row: x = a_i.  On entry W T = e + W o with e[0] = 0 (the
// previous row's reduced state; FIRST: T = 0); on exit the same with the
// arrays traded: the row's E in o, its O in e.
template <class P, bool FIRST>
__device__ __forceinline__ void cios_row(uint32_t* e, uint32_t* o, uint32_t x, const uint32_t* be,
                                         const uint32_t* bo, const Split<P>& n) {
  constexpr int L = P::L;
  if (FIRST) {
    row<L, true>(o, x, be);
    row<L, true>(e, x, bo);
  } else {
    o[0] = add_cc(o[0], e[1]);      // T = o + e / W: word 0 of e / W
    row_shift<L>(e, x, bo);  // O = e / W's words 1.. + x * b_odd
    row<L, false>(o, x, be);  // E = o + x * b_even
    e[L - 1] = addc(e[L - 1], 0u);  // E's carry, weight W^L, into O's top
  }
  const uint32_t m = o[0] * P::N0INV;
  row<L, false>(e, m, n.no);
  row<L, false>(o, m, n.ne);
  e[L - 1] = addc(e[L - 1], 0u);
}

}  // namespace ptx

struct MulLoopPtx : ModeTraits {
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    constexpr int L = P::L;
    static_assert(L % 2 == 0, "the pair runs need an even limb count");
    const ptx::Split<P> n;
    uint32_t be[L / 2], bo[L / 2];
    ptx::split<L>(b.v, be, bo);
    uint32_t E[L], O[L];
    ptx::cios_row<P, true>(E, O, a.v[0], be, bo, n);
    ptx::cios_row<P, false>(O, E, a.v[1], be, bo, n);
#pragma unroll
    for (int i = 2; i < L; i += 2) {
      ptx::cios_row<P, false>(E, O, a.v[i], be, bo, n);
      ptx::cios_row<P, false>(O, E, a.v[i + 1], be, bo, n);
    }
    // the last row left W T = E + W O with E[0] = 0: T = O + E / W
    O[0] = ptx::add_cc(O[0], E[1]);
#pragma unroll
    for (int j = 1; j < L - 1; ++j) O[j] = ptx::addc_cc(O[j], E[j + 1]);
    O[L - 1] = ptx::addc(O[L - 1], 0u);
    return ptx::csub<P>(O);
  }
};

struct MulV1Ptx : ModeTraits {
  template <class P>
  __device__ static __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
    constexpr int L = P::L;
    static_assert(L % 2 == 0, "the pair runs need an even limb count");
    uint32_t be[L / 2], bo[L / 2];
    ptx::split<L>(b.v, be, bo);
    // 1. the product a b = E + W O: row i adds a_i b_j (i + j even) to E's
    //    pairs from word i (even i) or i + 1, and the others to O's pairs
    //    from word i (even i) or i - 1; each run's carry goes to the word
    //    above it (E's last row cannot carry: a b < W^(2L))
    uint32_t E[2 * L], O[2 * L - 1];
#pragma unroll
    for (int j = 0; j < 2 * L; ++j) E[j] = 0;
#pragma unroll
    for (int j = 0; j < 2 * L - 1; ++j) O[j] = 0;
    ptx::row<L, true>(E, a.v[0], be);
    ptx::row<L, true>(O, a.v[0], bo);
#pragma unroll
    for (int i = 1; i < L; ++i) {
      const int se = i % 2 ? i + 1 : i, so = i % 2 ? i - 1 : i;
      const uint32_t* ve = i % 2 ? bo : be;
      const uint32_t* vo = i % 2 ? be : bo;
      ptx::row<L, false>(E + se, a.v[i], ve);
      if (se + L < 2 * L) E[se + L] = ptx::addc(E[se + L], 0u);
      ptx::row<L, false>(O + so, a.v[i], vo);
      O[so + L] = ptx::addc(O[so + L], 0u);
    }
    uint32_t t[2 * L];
    t[0] = E[0];
    t[1] = ptx::add_cc(E[1], O[0]);
#pragma unroll
    for (int j = 2; j < 2 * L - 1; ++j) t[j] = ptx::addc_cc(E[j], O[j - 1]);
    t[2 * L - 1] = ptx::addc(E[2 * L - 1], O[2 * L - 2]);
    // 2. L reduction rows on the low half (REDC of t_lo, W T = X + W Y with
    //    X[0] = 0 after each), as the CIOS rows without their products
    const ptx::Split<P> n;
    uint32_t X[L], Y[L];
#pragma unroll
    for (int j = 0; j < L; ++j) X[j] = t[j];
    uint32_t m = X[0] * P::N0INV;
    ptx::row<L, true>(Y, m, n.no);
    ptx::row<L, false>(X, m, n.ne);
    Y[L - 1] = ptx::addc(Y[L - 1], 0u);
#pragma unroll
    for (int i = 1; i < L; ++i) {
      uint32_t* e = i % 2 ? X : Y;  // the reduced array, shifted this row
      uint32_t* o = i % 2 ? Y : X;
      o[0] = ptx::add_cc(o[0], e[1]);
      m = o[0] * P::N0INV;
      ptx::row_shift<L>(e, m, n.no);
      ptx::row<L, false>(o, m, n.ne);
      e[L - 1] = ptx::addc(e[L - 1], 0u);
    }
    // the last row (i = L - 1, odd) left W T = Y + W X with Y[0] = 0:
    // REDC = X + Y / W; 3. plus the high half, < 2N
    X[0] = ptx::add_cc(X[0], Y[1]);
#pragma unroll
    for (int j = 1; j < L - 1; ++j) X[j] = ptx::addc_cc(X[j], Y[j + 1]);
    X[L - 1] = ptx::addc(X[L - 1], 0u);
    X[0] = ptx::add_cc(X[0], t[L]);
#pragma unroll
    for (int j = 1; j < L - 1; ++j) X[j] = ptx::addc_cc(X[j], t[L + j]);
    X[L - 1] = ptx::addc(X[L - 1], t[2 * L - 1]);
    return ptx::csub<P>(X);
  }
};
