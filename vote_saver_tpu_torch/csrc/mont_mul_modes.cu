// K1 in the multiplier modes v1 and fold, and their extern "C" launchers.
//
//   k_mont_mul_mode<P, MulV1>   <- pallas_field._mul_call (call l.786) with
//                                  VSTPU_MUL=v1 (FqEmit.mul, l.115-139)
//   k_mont_mul_mode<P, MulFold> <- the same call with VSTPU_MUL=fold
//                                  (FqEmitFold, l.187-224; ops/fold_mul.py)
//
// for P = Fq and Fr.  K1 in the default loop mode is k_mont_mul in
// kernels.cu.  One thread per lane over (B, L) int32 tensors read as
// uint32_t*; the modes and what bounds each are described in
// mul_modes.cuh.  This is its own translation unit, so nvcc builds it beside
// kernels.cu.  The fold reads its matrix from __constant__ memory, which
// vs_mont_mul_fold_upload fills once per loaded library.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "mul_modes.cuh"

namespace {

constexpr int kThreads = 128;

template <class P, class M>
__global__ void __launch_bounds__(kThreads)
    k_mont_mul_mode(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp<P> x, y;
  load(x, a, i);
  load(y, b, i);
  store(out, i, M::mul(x, y));
}

template <class P>
void launch(int mode, const void* a, const void* b, void* out, long long n, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (mode == 1) {
    k_mont_mul_mode<P, MulV1><<<blocks, kThreads, 0, s>>>(pa, pb, po, n);
  } else {
    k_mont_mul_mode<P, MulFold><<<blocks, kThreads, 0, s>>>(pa, pb, po, n);
  }
}

}  // namespace

extern "C" {

// field: 0 = Fq, 1 = Fr; mode: 1 = v1, 2 = fold.
int vs_mont_mul_mode(int field, int mode, const void* a, const void* b, void* out, long long n,
                     void* stream) {
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (field == 0) {
    launch<FqParams>(mode, a, b, out, n, s);
  } else {
    launch<FrParams>(mode, a, b, out, n, s);
  }
  return (int)cudaGetLastError();
}

// words: ops/fold_mul.packed_matrix of the field, nwords int32 words.
int vs_mont_mul_fold_upload(int field, const void* words, long long nwords) {
  return fold_upload(field, words, nwords);
}

}  // extern "C"
