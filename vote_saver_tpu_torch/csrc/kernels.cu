// K1 and the loop-mode instances of the curve kernels, with their extern
// "C" launchers.
//
//   K1 k_mont_mul<P>  <- pallas_field._mul_call / mont_mul_pallas (Fq, Fr)
//      k_mont_inv<P, MulLoop> <- the same call, repeated by
//                        field_ops.FieldOps.inv's lax.scan: the whole Fermat
//                        inversion in one launch
//   K2 k_madd, k_madd_scan; K3 k_add (G1), k_add_shift; K4 k_double: the
//                        templates of curve_kernels.cuh (which says what
//                        each replaces), G1 as Called<MulLoop>, G2 as MulLoop
//
// in the default `loop` multiplier mode (VSTPU_MUL unset or loop): CIOS,
// K1 and the inversion inlined, the G1 curve kernels calling one
// out-of-line copy of its body (field.cuh says why).  K3 in G2 is the team
// kernel of add_team.cu, K3d and K5/K6 are add_distinct.cu's; K1 in the
// other modes is mont_mul_modes.cu's, the curve kernels in them
// curve_v1.cu's and curve_fold.cu's.
//
// K1 is one thread per lane over (B, L) int32 tensors read as uint4*, with
// every limb in registers; the tensors keep the framework layout, so
// nothing is repacked per call.
//
// Launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "curve_kernels.cuh"

namespace {

// Lane i of the product is a[i] * b[i % nb]: nb = n for two operands of
// one shape, nb < n for a table broadcast over the batch (twiddles, the
// COO coefficients, a constant), which the kernel then reads in place
// instead of from a materialised copy of n lanes.
//
// What bounds it at the vote path's large shapes (B = 16 rows of 2^15 to
// 41,007 x 16 lanes, the matmul NTT's twiddle at 2^19): bytes, with the
// 136 (Fr) / 300 (Fq) multiply-adds a lane close behind in Fr.  A lane's
// limbs move as 16-byte accesses (two in Fr, three in Fq; the wrapper
// hands 16-byte aligned tensors), every load of a and b issued before the
// multiply, so a thread keeps 64 (Fr) / 96 (Fq) bytes in flight.  The
// modulo is 32-bit where n allows (every path shape).
template <class P>
__global__ void __launch_bounds__(kThreads)
    k_mont_mul(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out,
               long long n, long long nb) {
  constexpr int V = P::L / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = nb == n ? i
                      : n <= 0xffffffffLL ? (long long)((uint32_t)i % (uint32_t)nb)
                                          : i % nb;
  uint4 va[V], vb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    va[k] = __ldg(a + i * V + k);
    vb[k] = __ldg(b + j * V + k);
  }
  Fp<P> x, y;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x.v[4 * k] = va[k].x, x.v[4 * k + 1] = va[k].y, x.v[4 * k + 2] = va[k].z, x.v[4 * k + 3] = va[k].w;
    y.v[4 * k] = vb[k].x, y.v[4 * k + 1] = vb[k].y, y.v[4 * k + 2] = vb[k].z, y.v[4 * k + 3] = vb[k].w;
  }
  const Fp<P> z = mul(x, y);
#pragma unroll
  for (int k = 0; k < V; ++k) out[i * V + k] = make_uint4(z.v[4 * k], z.v[4 * k + 1], z.v[4 * k + 2], z.v[4 * k + 3]);
}

}  // namespace

extern "C" {

// field: 0 = Fq, 1 = Fr; a and out (n, L), b (nb, L) with nb dividing n,
// each 16-byte aligned.
int vs_mont_mul(int field, const void* a, const void* b, void* out, long long n, long long nb,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using v4p = const uint4*;
  if (field == 0) {
    k_mont_mul<FqParams><<<blocks_for(n), kThreads, 0, s>>>((v4p)a, (v4p)b, (uint4*)out, n, nb);
  } else {
    k_mont_mul<FrParams><<<blocks_for(n), kThreads, 0, s>>>((v4p)a, (v4p)b, (uint4*)out, n, nb);
  }
  return (int)cudaGetLastError();
}

// g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2 coordinates).
int vs_madd(int g2, const void* ax, const void* ay, const void* az, const void* qx,
            const void* qy, const void* sign, const void* active, void* ox, void* oy,
            void* oz, void* exc, long long n, void* stream) {
  return launch_madd<Called<MulLoop>, MulLoop>(g2, ax, ay, az, qx, qy, sign, active, ox, oy, oz, exc,
                                               n, stream);
}

int vs_g1_add(const void* px, const void* py, const void* pz, const void* qx, const void* qy,
              const void* qz, void* ox, void* oy, void* oz, long long n, void* stream) {
  return launch_g1_add<Called<MulLoop>>(px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

int vs_mont_inv(int field, const void* a, void* out, long long n, void* stream) {
  return launch_mont_inv<MulLoop>(field, a, out, n, stream);
}

int vs_double(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
              void* oz, long long n, int times, void* stream) {
  return launch_double<Called<MulLoop>, MulLoop>(g2, px, py, pz, ox, oy, oz, n, times, stream);
}

int vs_madd_scan(int g2, const void* px, const void* py, const void* codes, int steps,
                 long long lanes, void* ox, void* oy, void* oz, void* exc, void* stream) {
  return launch_madd_scan<Called<MulLoop>, MulLoop>(g2, px, py, codes, steps, lanes, ox, oy, oz, exc,
                                                    stream);
}

int vs_add_shift(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
                 void* oz, long long n, int bw, int shift, void* stream) {
  return launch_add_shift<Called<MulLoop>, MulLoop>(g2, px, py, pz, ox, oy, oz, n, bw, shift,
                                                    stream);
}

}  // extern "C"
