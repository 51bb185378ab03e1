// The curve kernels K2-K6, K3d and K1's Fermat chain in the fold
// multiplier mode, their extern "C" launchers and the unit's fold-matrix
// upload.
//
// Replaces the same pallas_calls as their loop instances (curve_kernels.cuh,
// add_team.cuh), compiled with VSTPU_MUL=fold: every Fq multiply of the
// formulas through FqEmitFold (pallas_field.py l.187-224, with the fold
// matrix as the kernel's extra input, _fold_inputs l.286-298), MulFold here
// (mul_modes.cuh): fp32 digit columns, the reduction as one product with
// the constant matrix in this unit's __constant__ memory (dp4a, four rows a
// word), two 16-bit word steps and a conditional subtract.  What bounds a
// multiply: the 2,304 fp32 FMAs of the digit columns and the fold's 285 x
// 52 byte products (72 x 52 dp4a), one lane at a time.
//
// The matrix lives in this unit's own __constant__ memory (kFoldFq, and
// kFoldFr for the Fr inversion): vs_curve_fold_upload fills it, once per
// field, library and card, before the unit's first launch there
// (hopper_field.upload_fold_matrix; the wrappers call it).  Launchers:
// curve_unit.cuh, each named as its loop launcher with `_fold`.

#define VS_MODE MulFold
#define VS_SUFFIX _fold
#include "curve_unit.cuh"

extern "C" {

// words: ops/fold_mul.packed_matrix of the field (0 = Fq, 1 = Fr), nwords
// int32 words.
int vs_curve_fold_upload(int field, const void* words, long long nwords) {
  return fold_upload(field, words, nwords);
}

}  // extern "C"
