// K3d: the distinct-operand Jacobian add and its extern "C" launcher.
//
//   k_add_distinct<E> <- pallas_field._g1_add_call / _g2_add_call with
//                        complete=False (the calls at l.517 / l.570; formula
//                        _jac_add, l.406-441), reached through
//                        JacobianOps.add_distinct by FixedBaseTable.mul's
//                        window sum, i.e. by Groth16 setup on the device.
//
// One thread per lane over (B, L) / (B, 2, L) int32 tensors read as
// uint32_t*, as the kernels of kernels.cu.  What bounds it: the 16 field
// multiplies of the generic add (x3 in Fq2 for G2), i.e. integer multiply
// throughput; it drops the complete add's doubling branch, so its register
// live range is the generic formula's alone.  It is its own translation
// unit, so nvcc builds it beside kernels.cu, not after it.
//
// The launcher runs on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <class E>
__global__ void __launch_bounds__(kThreads)
    k_add_distinct(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
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
  const Jac<E> r = jac_add_distinct(p, q);
  store(ox, i, r.x);
  store(oy, i, r.y);
  store(oz, i, r.z);
}

using u32p = const uint32_t*;

}  // namespace

extern "C" {

// g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2 coordinates).
int vs_add_distinct(int g2, const void* px, const void* py, const void* pz, const void* qx,
                    const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (g2) {
    k_add_distinct<Fq2><<<blocks, kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx,
                                                     (u32p)qy, (u32p)qz, (uint32_t*)ox,
                                                     (uint32_t*)oy, (uint32_t*)oz, n);
  } else {
    k_add_distinct<Fq><<<blocks, kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx,
                                                    (u32p)qy, (u32p)qz, (uint32_t*)ox,
                                                    (uint32_t*)oy, (uint32_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
