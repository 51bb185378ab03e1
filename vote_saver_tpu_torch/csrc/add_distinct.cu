// The distinct-operand Jacobian adds K3d and K5/K6 and their extern "C"
// launchers.
//
//   k_add_distinct<E> <- pallas_field._g1_add_call / _g2_add_call with
//                        complete=False (the calls at l.517 / l.570; formula
//                        _jac_add, l.406-441), reached through
//                        JacobianOps.add_distinct by FixedBaseTable.mul's
//                        window sum, i.e. by Groth16 setup on the device.
//   k_addx<E>         <- pallas_field._g1_addx_call / _g2_addx_call (the
//                        calls at l.626 / l.656; formula _jac_addx,
//                        l.366-403): the same add plus the per-lane
//                        doubling-corner flag, reached through
//                        msm_sched._addx(group, distinct=True) by the MSM
//                        combination phase.
//
// One thread per lane over (B, L) / (B, 2, L) int32 tensors read as
// uint32_t*, as the kernels of kernels.cu.  What bounds them: the 16 field
// multiplies of the generic add (x3 in Fq2 for G2), i.e. integer multiply
// throughput; they drop the complete add's doubling branch, so their
// register live range is the generic formula's alone.  They are their own
// translation unit, so nvcc builds them beside kernels.cu, not after it.
// Both take the multiplier mode as a template parameter and are
// instantiated in `loop` only.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <class E, class M = MulLoop>
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
  const Jac<E> r = jac_add_distinct<E, M>(p, q);
  store(ox, i, r.x);
  store(oy, i, r.y);
  store(oz, i, r.z);
}

// exc[i] = 1 where lane i hit the doubling corner (p = q, both finite)
template <class E, class M = MulLoop>
__global__ void __launch_bounds__(kThreads)
    k_addx(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
           const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
           uint32_t* ox, uint32_t* oy, uint32_t* oz, int32_t* exc, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> p, q;
  load(p.x, px, i);
  load(p.y, py, i);
  load(p.z, pz, i);
  load(q.x, qx, i);
  load(q.y, qy, i);
  load(q.z, qz, i);
  uint32_t e;
  const Jac<E> r = jac_addx<E, M>(p, q, e);
  store(ox, i, r.x);
  store(oy, i, r.y);
  store(oz, i, r.z);
  exc[i] = (int32_t)e;
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

// K5 (g2 = 0) / K6 (g2 = 1); exc: (n,) int32.
int vs_addx(int g2, const void* px, const void* py, const void* pz, const void* qx,
            const void* qy, const void* qz, void* ox, void* oy, void* oz, void* exc,
            long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (g2) {
    k_addx<Fq2><<<blocks, kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy,
                                            (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
                                            (uint32_t*)oz, (int32_t*)exc, n);
  } else {
    k_addx<Fq><<<blocks, kThreads, 0, s>>>((u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy,
                                           (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
                                           (uint32_t*)oz, (int32_t*)exc, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
