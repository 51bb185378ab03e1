// The multiply probes K7-K10 and their extern "C" launchers.
//
//   k_mul_chain<P, M, CHAINS, UNROLL> (probe table kChains below)
//     K7  <- bench.py:bench_field_mul (pallas_call l.302): 4 independent
//            chains x 6 chained Fq multiplies, in a given mode;
//     K8  <- scripts/micro_cios_loop.py:make_call (l.108): 4 chains x 8,
//            loop against v1;
//     K10 <- scripts/micro_mul_chain.py:build (l.59): one dependent chain of
//            16, v1 against fold (multiply latency);
//   k_op<KIND, CHAINS> (K9) <- scripts/micro_vpu2.py:build (l.53): one
//            primitive op kind unrolled 512 deep with loop-index-dependent
//            constants, so nothing reassociates; the six kinds of the JAX
//            probe plus u32_mul_wide, (uint64) x * y + c, the op the port's
//            32-bit limb arithmetic compiles to (IMAD.WIDE).  With CHAINS = 1
//            each lane runs one dependent chain, as the JAX probe does; the
//            integer kinds also run as CHAINS = 8 independent chains of 64
//            (the _x8 kinds), which hides the op's latency and measures its
//            throughput.  Chain j starts at x + j and takes the constants
//            y + 8r + j, so no two chains share a product.
//
// A chain lane i runs chain k from x[(i + k) % n] (the JAX probes roll the
// tile to make the chains distinct) against y[i]; out0 is chain 0, out1 the
// field sum of chains 1.. (as the JAX kernels write them).  What bounds
// them: the multiplies (mul_modes.cuh) and, for K9, the op itself; none
// touches memory between its load and its store.  K9 is the card's integer
// multiply-add yardstick: every curve kernel is bound by the 32x32->64
// multiply-add, whose rate this card's data sheet does not give.
//
// Built with -DVS_K8_ONLY=1 -DVS_K8_MUL=<mode type> this file holds only
// that K8 instance, which is how the K8 probe times one variant's build.
//
// Launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "mul_modes.cuh"

constexpr int kThreads = 128;

template <class P, class M, int CHAINS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    k_mul_chain(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ out0, uint32_t* __restrict__ out1, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp<P> c[CHAINS];
  Fp<P> b;
  load(b, y, i);
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) load(c[k], x, (i + k) % n);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) c[k] = M::mul(c[k], b);
  }
  store(out0, i, c[0]);
  if (CHAINS > 1) {
    Fp<P> rest = c[1];
#pragma unroll
    for (int k = 2; k < CHAINS; ++k) rest = add(rest, c[k]);
    store(out1, i, rest);
  }
}

#ifdef VS_K8_ONLY

template __global__ void k_mul_chain<FqParams, VS_K8_MUL, 4, 8>(const uint32_t*, const uint32_t*,
                                                                uint32_t*, uint32_t*, long long);

#else

constexpr int kOpUnroll = 512;

// K9's op kinds (micro.OP_KINDS lists the instances of kOps below)
enum OpKind : int {
  kU32Mul = 0,
  kU32MulMask,
  kU32ShiftAdd,
  kF32Fma,
  kF32MulAdd,
  kCvtF32U32,
  kU32MulWide,
};

// one step of an integer kind on chain state (x, or w for u32_mul_wide)
template <int KIND>
__device__ __forceinline__ void int_step(uint32_t& x, uint64_t& w, uint32_t yk) {
  if (KIND == kU32Mul) {
    x = x * yk;  // mul (+ the add of yk)
  } else if (KIND == kU32MulMask) {
    x = (x * yk) & 0xFFFFu;  // mul + and (+ add)
  } else if (KIND == kU32ShiftAdd) {
    x = (x >> 1) + yk;  // shr + add (+ add)
  } else {
    w = (uint64_t)(uint32_t)w * yk + (w >> 32);  // mul-wide (+ add)
  }
}

template <int KIND, int CHAINS>
__global__ void __launch_bounds__(kThreads)
    k_op(const uint32_t* __restrict__ xin, const uint32_t* __restrict__ yin,
         uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (KIND == kF32Fma || KIND == kF32MulAdd) {
    float x = __uint_as_float(xin[i]);
    const float y = __uint_as_float(yin[i]);
#pragma unroll
    for (int k = 0; k < kOpUnroll; ++k) {
      if (KIND == kF32Fma) {
        x = fmaf(x, y, (float)k);  // one fma
      } else {
        x = __fmul_rn(x, __fadd_rn(y, (float)k));  // mul + add
      }
    }
    out[i] = __float_as_uint(x);
    return;
  }
  if (KIND == kCvtF32U32) {
    uint32_t x = xin[i];
#pragma unroll
    for (int k = 0; k < kOpUnroll / 2; ++k) {
      x = (uint32_t)__uint2float_rn(x + (uint32_t)k);  // add + 2 cvts
    }
    out[i] = x;
    return;
  }
  const uint32_t y = yin[i];
  uint32_t x[CHAINS];
  uint64_t w[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    x[j] = xin[i] + (uint32_t)j;
    w[j] = x[j];
  }
#pragma unroll
  for (int r = 0; r < kOpUnroll / CHAINS; ++r) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) int_step<KIND>(x[j], w[j], y + (uint32_t)(r * CHAINS + j));
  }
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) sum += KIND == kU32MulWide ? (uint32_t)w[j] : x[j];
  out[i] = sum;
}

using ChainFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*, uint32_t*, long long);

// probe index -> instance, in the order of micro.CHAIN_PROBES
const ChainFn kChains[] = {
    k_mul_chain<FqParams, MulLoop, 4, 6>,   // K7 loop
    k_mul_chain<FqParams, MulV1, 4, 6>,     // K7 v1
    k_mul_chain<FqParams, MulFold, 4, 6>,   // K7 fold
    k_mul_chain<FqParams, MulLoop, 4, 8>,   // K8 loop
    k_mul_chain<FqParams, MulV1, 4, 8>,     // K8 v1
    k_mul_chain<FqParams, MulV1, 1, 16>,    // K10 v1
    k_mul_chain<FqParams, MulFold, 1, 16>,  // K10 fold
};
constexpr int kNumChains = sizeof(kChains) / sizeof(kChains[0]);

using OpFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*, long long);

// kind index -> instance, in the order of micro.OP_KINDS
const OpFn kOps[] = {
    k_op<kU32Mul, 1>,      k_op<kU32MulMask, 1>,  k_op<kU32ShiftAdd, 1>,
    k_op<kF32Fma, 1>,      k_op<kF32MulAdd, 1>,   k_op<kCvtF32U32, 1>,
    k_op<kU32MulWide, 1>,  k_op<kU32Mul, 8>,      k_op<kU32MulMask, 8>,
    k_op<kU32ShiftAdd, 8>, k_op<kU32MulWide, 8>,
};
constexpr int kNumOps = sizeof(kOps) / sizeof(kOps[0]);

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

extern "C" {

int vs_mul_chain(int probe, const void* x, const void* y, void* out0, void* out1, long long n,
                 void* stream) {
  if (probe < 0 || probe >= kNumChains) return (int)cudaErrorInvalidValue;
  kChains[probe]<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1), n);
  return (int)cudaGetLastError();
}

int vs_op(int kind, const void* x, const void* y, void* out, long long n, void* stream) {
  if (kind < 0 || kind >= kNumOps) return (int)cudaErrorInvalidValue;
  kOps[kind]<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

int vs_micro_fold_upload(int field, const void* words, long long nwords) {
  return fold_upload(field, words, nwords);
}

}  // extern "C"

#endif  // VS_K8_ONLY
