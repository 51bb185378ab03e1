// The extern "C" launchers of one multiplier mode's curve unit: every curve
// kernel of curve_kernels.cuh and the team add of add_team.cuh, plus K1's
// Fermat chain, in the mode the including unit names.  Before including it,
// a unit defines
//
//   VS_MODE    the multiplier mode type (MulV1, MulFold; mul_modes.cuh)
//   VS_SUFFIX  the launchers' name suffix (_v1, _fold)
//
// and may define
//
//   VS_MODE_G1_MMA  the mode of the G1 bucket scan, the G1 suffix round,
//                   the G1 doubling and the G1 complete add (default
//                   Called<VS_MODE>; the fold unit's: Called<MulFoldMma>,
//                   the fold product on the tensor cores)
//   VS_MODE_G2_MMA  the mode of the G2 bucket scan, the G2 suffix round,
//                   the G2 doubling and the G2 team add (default VS_MODE;
//                   the fold unit's: MulFoldMma)
//   VS_MODE_FQ_MMA  the mode of the Fq inversion chain (default VS_MODE;
//                   the fold unit's: MulFoldMma)
//   VS_MODE_FR_MMA  the mode of the Fr inversion chain (default VS_MODE;
//                   the fold unit's: MulFoldMmaOf<FrParams>)
//
// and gets vs_mont_inv<suffix>, vs_madd<suffix>, vs_g1_add<suffix>,
// vs_g2_add_team<suffix>, vs_double<suffix>, vs_madd_scan<suffix>,
// vs_add_shift<suffix>, vs_add_distinct<suffix>, vs_window_sum<suffix> and
// vs_addx<suffix>, each
// with the signature of the loop launcher of the same name (kernels.cu,
// add_team.cu, add_distinct.cu; the window sum here only at kWindowTeam
// threads an output).  Every G1 kernel takes Called<VS_MODE>
// (one out-of-line copy of the mode's multiply a kernel) but the scan, the
// suffix round, the doubling and the complete add, which take
// VS_MODE_G1_MMA, every G2 kernel VS_MODE (its Fq2 multiply calls the Fq
// one out of line) but the scan, the suffix round, the doubling and the
// team add, which take VS_MODE_G2_MMA, the Fq inversion chain
// VS_MODE_FQ_MMA, the Fr inversion chain VS_MODE_FR_MMA.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).
#pragma once

#include "add_team.cuh"
#include "curve_kernels.cuh"

#define VS_CAT_(a, b) a##b
#define VS_CAT(a, b) VS_CAT_(a, b)
#define VS_FN(name) VS_CAT(name, VS_SUFFIX)

namespace {
using ModeG1 = Called<VS_MODE>;
using ModeG2 = VS_MODE;
#ifdef VS_MODE_G1_MMA
using ModeG1Mma = VS_MODE_G1_MMA;
#else
using ModeG1Mma = ModeG1;
#endif
#ifdef VS_MODE_G2_MMA
using ModeG2Mma = VS_MODE_G2_MMA;
#else
using ModeG2Mma = ModeG2;
#endif
#ifdef VS_MODE_FQ_MMA
using ModeFqMma = VS_MODE_FQ_MMA;
#else
using ModeFqMma = VS_MODE;
#endif
#ifdef VS_MODE_FR_MMA
using ModeFrMma = VS_MODE_FR_MMA;
#else
using ModeFrMma = VS_MODE;
#endif
}  // namespace

extern "C" {

// field: 0 = Fq, 1 = Fr.
int VS_FN(vs_mont_inv)(int field, const void* a, void* out, long long n, void* stream) {
  return launch_mont_inv<ModeFqMma, ModeFrMma>(field, a, out, n, stream);
}

// g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2 coordinates), here and below.
int VS_FN(vs_madd)(int g2, const void* ax, const void* ay, const void* az, const void* qx,
                   const void* qy, const void* sign, const void* active, void* ox, void* oy,
                   void* oz, void* exc, long long n, void* stream) {
  return launch_madd<ModeG1, ModeG2>(g2, ax, ay, az, qx, qy, sign, active, ox, oy, oz, exc, n,
                                     stream);
}

int VS_FN(vs_g1_add)(const void* px, const void* py, const void* pz, const void* qx,
                     const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                     void* stream) {
  return launch_g1_add<ModeG1Mma>(px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

// coordinates (n, 2, 12) each, 16-byte aligned; outputs not aliasing inputs.
int VS_FN(vs_g2_add_team)(const void* px, const void* py, const void* pz, const void* qx,
                          const void* qy, const void* qz, void* ox, void* oy, void* oz,
                          long long n, void* stream) {
  return launch_g2_add_team<ModeG2Mma>(px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

int VS_FN(vs_double)(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
                     void* oz, long long n, int times, void* stream) {
  return launch_double<ModeG1Mma, ModeG2Mma>(g2, px, py, pz, ox, oy, oz, n, times, stream);
}

int VS_FN(vs_madd_scan)(int g2, const void* px, const void* py, const void* codes, int steps,
                        long long lanes, void* ox, void* oy, void* oz, void* exc, void* stream) {
  return launch_madd_scan<ModeG1Mma, ModeG2Mma>(g2, px, py, codes, steps, lanes, ox, oy, oz, exc,
                                                   stream);
}

int VS_FN(vs_add_shift)(int g2, const void* px, const void* py, const void* pz, void* ox,
                        void* oy, void* oz, long long n, int bw, int shift, void* stream) {
  return launch_add_shift<ModeG1Mma, ModeG2Mma>(g2, px, py, pz, ox, oy, oz, n, bw, shift, stream);
}

int VS_FN(vs_add_distinct)(int g2, const void* px, const void* py, const void* pz,
                           const void* qx, const void* qy, const void* qz, void* ox, void* oy,
                           void* oz, long long n, void* stream) {
  return launch_add_distinct<ModeG1, ModeG2>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

int VS_FN(vs_window_sum)(int g2, const void* tx, const void* ty, const void* tz, const void* digits,
                         void* ox, void* oy, void* oz, long long n, int team, void* stream) {
  return launch_window_sum<ModeG1, ModeG2, false>(g2, tx, ty, tz, digits, ox, oy, oz, n, team, stream);
}

int VS_FN(vs_addx)(int g2, const void* px, const void* py, const void* pz, const void* qx,
                   const void* qy, const void* qz, void* ox, void* oy, void* oz, void* exc,
                   long long n, void* stream) {
  return launch_addx<ModeG1, ModeG2>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, exc, n, stream);
}

}  // extern "C"
