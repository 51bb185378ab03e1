// The port's four Hopper kernels and their extern "C" launchers.
//
//   K1 k_mont_mul<P>  <- pallas_field._mul_call / mont_mul_pallas (Fq, Fr)
//   K2 k_madd<E>      <- pallas_field._g1_madd_call / _g2_madd_call
//   K3 k_add<E>       <- pallas_field._g1_add_call / _g2_add_call (complete)
//   K4 k_double<E>    <- pallas_field._g1_dbl_call / _g2_dbl_call
//
// Each is one thread per lane over (B, L) / (B, 2, L) int32 tensors read as
// uint32_t*, with every limb in registers.  The Pallas kernels tile the
// batch into (S, T) vregs and transpose to (L, S, T) around every call; here
// the tensors keep the framework layout, so nothing is repacked per call.
// Bound and design notes: field.cuh (arithmetic) and curve.cuh (formulas).
// Register use and spills per kernel are printed by `nvcc --resource-usage`
// at build time (ops/_build.py keeps the report beside the library).
//
// Launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

__host__ __forceinline__ unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    k_mont_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp<P> x, y;
  load(x, a, i);
  load(y, b, i);
  store(out, i, mul(x, y));
}

// In-place safe: every lane reads all of its inputs before it writes.
template <class E>
__global__ void __launch_bounds__(kThreads)
    k_madd(const uint32_t* ax, const uint32_t* ay, const uint32_t* az,
           const uint32_t* qx, const uint32_t* qy, const uint8_t* sign,
           const uint8_t* active, uint32_t* ox, uint32_t* oy, uint32_t* oz,
           int32_t* exc, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> acc;
  E x2, y2;
  load(acc.x, ax, i);
  load(acc.y, ay, i);
  load(acc.z, az, i);
  load(x2, qx, i);
  load(y2, qy, i);
  const uint32_t e = jac_madd(acc, x2, y2, sign[i] != 0, active[i] != 0);
  store(ox, i, acc.x);
  store(oy, i, acc.y);
  store(oz, i, acc.z);
  exc[i] = (int32_t)e;
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    k_add(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
          const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
          uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> p, q;
  load(p.x, px, i);
  load(p.y, py, i);
  load(p.z, pz, i);
  load(q.x, qx, i);
  load(q.y, qy, i);
  load(q.z, qz, i);
  const Jac<E> r = jac_add(p, q);
  store(ox, i, r.x);
  store(oy, i, r.y);
  store(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    k_double(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> p;
  load(p.x, px, i);
  load(p.y, py, i);
  load(p.z, pz, i);
  const Jac<E> r = jac_double(p);
  store(ox, i, r.x);
  store(oy, i, r.y);
  store(oz, i, r.z);
}

using u32p = const uint32_t*;

}  // namespace

extern "C" {

// field: 0 = Fq, 1 = Fr.
int vs_mont_mul(int field, const void* a, const void* b, void* out, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (field == 0) {
    k_mont_mul<FqParams><<<blocks_for(n), kThreads, 0, s>>>((u32p)a, (u32p)b, (uint32_t*)out, n);
  } else {
    k_mont_mul<FrParams><<<blocks_for(n), kThreads, 0, s>>>((u32p)a, (u32p)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2 coordinates).
int vs_madd(int g2, const void* ax, const void* ay, const void* az, const void* qx,
            const void* qy, const void* sign, const void* active, void* ox, void* oy,
            void* oz, void* exc, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_madd<Fq2><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)ax, (u32p)ay, (u32p)az, (u32p)qx, (u32p)qy, (const uint8_t*)sign,
        (const uint8_t*)active, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)exc, n);
  } else {
    k_madd<Fq><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)ax, (u32p)ay, (u32p)az, (u32p)qx, (u32p)qy, (const uint8_t*)sign,
        (const uint8_t*)active, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)exc, n);
  }
  return (int)cudaGetLastError();
}

int vs_add(int g2, const void* px, const void* py, const void* pz, const void* qx,
           const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_add<Fq2><<<blocks_for(n), kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx,
                                                  (u32p)qy, (u32p)qz, (uint32_t*)ox,
                                                  (uint32_t*)oy, (uint32_t*)oz, n);
  } else {
    k_add<Fq><<<blocks_for(n), kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx,
                                                 (u32p)qy, (u32p)qz, (uint32_t*)ox,
                                                 (uint32_t*)oy, (uint32_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

int vs_double(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
              void* oz, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_double<Fq2><<<blocks_for(n), kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz,
                                                     (uint32_t*)ox, (uint32_t*)oy,
                                                     (uint32_t*)oz, n);
  } else {
    k_double<Fq><<<blocks_for(n), kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz,
                                                    (uint32_t*)ox, (uint32_t*)oy,
                                                    (uint32_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
