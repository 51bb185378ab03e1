// The multiply probes K7-K10 and their extern "C" launchers.
//
//   k_mul_chain<P, M, CHAINS, UNROLL>, k_mul_chain_mma<P, CHAINS, UNROLL>
//   (probe table kChains below)
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
// The fold probes (K7 fold, K10 fold) are k_mul_chain_mma: the fold with its
// fold product on the int8 tensor cores (fold_mma.cuh), the counterpart of
// fold_mul.fold_columns inside FqEmitFold, the one bf16 matmul the TPU
// kernel rides its matrix unit with.  Its bound is the fp32 digit columns
// (2,304 FMAs a multiply, each an issue slot); the design takes the 3,744
// per-lane dp4a and their 52 live accumulators out of the lane: a warp's 32
// lanes write their pieces into shared memory and multiply them by the fold
// matrix as one tile of 126 mma.sync.  Every thread of a warp stays in the
// multiply (a thread past n computes lane n - 1 and skips its store), the
// loop holds one copy of the multiply (the chains rotate through it), and
// the block copies the matrix into shared memory once.  Its dynamic shared
// memory, above 48 KB, is set per instance by the launcher.
//
// Built with -DVS_K8_ONLY=1 -DVS_K8_MUL=<mode type> this file holds only
// that K8 instance, which is how the K8 probe times one variant's build.
//
// Launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "fold_mma.cuh"

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

// The fold chains with the tensor-core fold: chain 0 is multiplied, then the
// chains rotate, so the loop holds one copy of the multiply.
template <class P, int CHAINS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    k_mul_chain_mma(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    uint32_t* __restrict__ out0, uint32_t* __restrict__ out1, long long n) {
  using F = FoldMma<P>;
  extern __shared__ __align__(16) uint8_t smem[];
  fold_mma_load_b<P>(smem);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (threadIdx.x & 31) >= n) return;  // the whole warp is past n
  const long long li = i < n ? i : n - 1;
  uint8_t* tile = smem + F::B_BYTES + (threadIdx.x >> 5) * F::WARP_BYTES;
  Fp<P> c[CHAINS];
  Fp<P> b;
  load(b, y, li);
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) load(c[k], x, (li + k) % n);
#pragma unroll 1
  for (int s = 0; s < CHAINS * UNROLL; ++s) {
    const Fp<P> r = mul_fold_mma<P>(c[0], b, smem, tile);
#pragma unroll
    for (int k = 0; k + 1 < CHAINS; ++k) c[k] = c[k + 1];
    c[CHAINS - 1] = r;
  }
  if (i >= n) return;
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

struct ChainProbe {
  ChainFn fn;
  int smem;  // dynamic shared memory a block, bytes
};

constexpr int kFoldMmaSmem = FoldMma<FqParams>::smem_bytes(kThreads);

// probe index -> instance, in the order of micro.CHAIN_PROBES
const ChainProbe kChains[] = {
    {k_mul_chain<FqParams, MulLoop, 4, 6>, 0},         // K7 loop
    {k_mul_chain<FqParams, MulV1, 4, 6>, 0},           // K7 v1
    {k_mul_chain_mma<FqParams, 4, 6>, kFoldMmaSmem},   // K7 fold
    {k_mul_chain<FqParams, MulLoop, 4, 8>, 0},         // K8 loop
    {k_mul_chain<FqParams, MulV1, 4, 8>, 0},           // K8 v1
    {k_mul_chain<FqParams, MulV1, 1, 16>, 0},          // K10 v1
    {k_mul_chain_mma<FqParams, 1, 16>, kFoldMmaSmem},  // K10 fold
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
  const ChainProbe& p = kChains[probe];
  const int err = allow_smem(reinterpret_cast<const void*>(p.fn), p.smem);
  if (err != 0) return err;
  p.fn<<<blocks_for(n), kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1), n);
  return (int)cudaGetLastError();
}

// What the runtime reports of probe's instance on the current device:
// fold_mma.cuh's kernel_info.
int vs_mul_chain_info(int probe, int* out) {
  if (probe < 0 || probe >= kNumChains) return (int)cudaErrorInvalidValue;
  const ChainProbe& p = kChains[probe];
  return kernel_info(reinterpret_cast<const void*>(p.fn), kThreads, p.smem, out);
}

int vs_op(int kind, const void* x, const void* y, void* out, long long n, void* stream) {
  if (kind < 0 || kind >= kNumOps) return (int)cudaErrorInvalidValue;
  kOps[kind]<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// bytes: ops/fold_mul.mma_operand of Fq, nbytes long.
int vs_micro_fold_mma_upload(int field, const void* bytes, long long nbytes) {
  return fold_mma_upload(field, bytes, nbytes);
}

}  // extern "C"

#endif  // VS_K8_ONLY
