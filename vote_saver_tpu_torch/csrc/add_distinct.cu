// The loop-mode instances of the distinct-operand Jacobian adds K3d (and
// its window sum) and K5/K6 and their extern "C" launchers.
//
//   k_add_distinct<E, MulLoop> <- pallas_field._g1_add_call / _g2_add_call
//                        with complete=False (the calls at l.517 / l.570;
//                        formula _jac_add, l.406-441), reached through
//                        JacobianOps.add_distinct; no path runs it since
//                        setup's window sum is k_window_sum.
//   k_window_sum<E, MulLoop, T> <- the same call, repeated by
//                        FixedBaseTable.mul's window sum (curve_ops'
//                        sum_reduce(distinct=True)), i.e. by Groth16 setup
//                        on the device: the gather and all 31 adds of an
//                        output in one launch, a team of T threads an output.
//   k_addx<E, MulLoop> <- pallas_field._g1_addx_call / _g2_addx_call (the
//                        calls at l.626 / l.656; formula _jac_addx,
//                        l.366-403): the same add plus the per-lane
//                        doubling-corner flag, reached through
//                        msm_sched._addx(group, distinct=True) by the MSM
//                        combination phase.
//
// The kernels are curve_kernels.cuh's templates (which say what bounds
// them); here G1 and G2 both take MulLoop, so the G1 instances inline the
// CIOS body.  They are their own translation unit, so nvcc builds them
// beside kernels.cu, not after it; their v1 and fold instances are in
// curve_v1.cu and curve_fold.cu.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).

#include "curve_kernels.cuh"

extern "C" {

// g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2 coordinates).
int vs_add_distinct(int g2, const void* px, const void* py, const void* pz, const void* qx,
                    const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                    void* stream) {
  return launch_add_distinct<MulLoop, MulLoop>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

// table (32, 256, ...) x3, 16-byte aligned; digits (n, 32) int32 below
// 256; team 1, 2, 4 or 8 threads an output (the other units build only
// kWindowTeam).
int vs_window_sum(int g2, const void* tx, const void* ty, const void* tz, const void* digits, void* ox,
                  void* oy, void* oz, long long n, int team, void* stream) {
  return launch_window_sum<MulLoop, MulLoop, true>(g2, tx, ty, tz, digits, ox, oy, oz, n, team, stream);
}

// K5 (g2 = 0) / K6 (g2 = 1); exc: (n,) int32.
int vs_addx(int g2, const void* px, const void* py, const void* pz, const void* qx,
            const void* qy, const void* qz, void* ox, void* oy, void* oz, void* exc,
            long long n, void* stream) {
  return launch_addx<MulLoop, MulLoop>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, exc, n, stream);
}

}  // extern "C"
