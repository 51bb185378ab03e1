// The curve kernels K2-K6, K3d and K1's Fermat chain in the v1 multiplier
// mode, and their extern "C" launchers.
//
// Replaces the same pallas_calls as their loop instances (curve_kernels.cuh,
// add_team.cuh), compiled with VSTPU_MUL=v1: every Fq multiply of the
// formulas through FqEmit.mul (pallas_field.py l.115-139), separated
// operand scanning, MulV1 here (mul_modes.cuh).  Same multiply-adds as
// loop (2L^2 + L a multiply), so the same bound; the full 2L-word product
// is kept before the reduction, so a multiply holds more registers.
// Launchers: curve_unit.cuh, each named as its loop launcher with `_v1`.

#define VS_MODE MulV1
#define VS_SUFFIX _v1
#include "curve_unit.cuh"
