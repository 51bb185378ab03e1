// The curve kernels K2-K6, K3d and K1's Fermat chain in the fold
// multiplier mode, their extern "C" launchers and the unit's fold-matrix
// uploads.
//
// Replaces the same pallas_calls as their loop instances (curve_kernels.cuh,
// add_team.cuh), compiled with VSTPU_MUL=fold: every Fq multiply of the
// formulas through FqEmitFold (pallas_field.py l.187-224, with the fold
// matrix as the kernel's extra input, _fold_inputs l.286-298): fp32 digit
// columns, the reduction as one product with the constant matrix, two
// 16-bit word steps and a conditional subtract.  Two forms of that product:
//
//   * the G1 bucket scan (k_madd_scan) and the G1 doubling (k_double):
//     Called<MulFoldMma> (fold_mma.cuh), the product a warp's 32 lanes at
//     once as 126 mma.sync on the int8 tensor cores, the B operand in this
//     unit's device memory (kFoldMmaFq), copied into each block's shared
//     memory by the kernel's prologue.  What bounds a multiply there: the
//     2,304 fp32 FMAs of the digit columns, one issue slot each.  Both
//     kernels run in their converged form (curve_kernels.cuh).
//   * every other kernel: MulFold (mul_modes.cuh), the product as 72 x 52
//     dp4a a lane against the matrix in this unit's __constant__ memory;
//     bound by the 2,304 FMAs and those 3,744 dp4a with their constant
//     reads, one lane at a time.
//
// The matrices live in this unit's own memory (kFoldFq, and kFoldFr for the
// Fr inversion, in __constant__; kFoldMmaFq): vs_curve_fold_upload and
// vs_curve_fold_mma_upload fill them, once per field, library and card,
// before the unit's first launch there (hopper_field.upload_fold_matrix;
// the wrappers call it).  The B operand's upload also lifts the two
// tensor-core instances' limit of dynamic shared memory on the card, once,
// so their launches need no attribute call.  Launchers: curve_unit.cuh,
// each named as its loop launcher with `_fold`.  The multiply is called,
// not inlined: inlined, the scan took 70.75 ms a call against 45.4-45.5
// and the doubling at 16 lanes x 10 2.2x as long (PERF.md).

#include "fold_mma.cuh"

#define VS_MODE MulFold
#define VS_SUFFIX _fold
#define VS_MODE_G1_MMA Called<MulFoldMma>
#include "curve_unit.cuh"

namespace {

constexpr int kMmaSmem = ModeG1Mma::smem_bytes(kThreads);

// the tensor-core instances, in the order of hopper_field.MMA_KERNELS
const void* const kMmaKernels[] = {
    reinterpret_cast<const void*>(k_madd_scan<Fq, ModeG1Mma>),
    reinterpret_cast<const void*>(k_double<Fq, ModeG1Mma>),
};

}  // namespace

extern "C" {

// words: ops/fold_mul.packed_matrix of the field (0 = Fq, 1 = Fr), nwords
// int32 words.
int vs_curve_fold_upload(int field, const void* words, long long nwords) {
  return fold_upload(field, words, nwords);
}

// bytes: ops/fold_mul.mma_operand of Fq (field 0), nbytes long.  Also lets
// the tensor-core instances take their dynamic shared memory on the current
// device.
int vs_curve_fold_mma_upload(int field, const void* bytes, long long nbytes) {
  int err = fold_mma_upload(field, bytes, nbytes);
  for (const void* k : kMmaKernels) {
    if (err == 0) err = allow_smem(k, kMmaSmem);
  }
  return err;
}

// What the CUDA runtime reports of tensor-core instance `kernel`
// (kMmaKernels) on the current device: fold_mma.cuh's kernel_info.
int vs_curve_fold_mma_info(int kernel, int* out) {
  if (kernel < 0 || kernel >= (int)(sizeof(kMmaKernels) / sizeof(kMmaKernels[0]))) {
    return (int)cudaErrorInvalidValue;
  }
  return kernel_info(kMmaKernels[kernel], kThreads, kMmaSmem, out);
}

}  // extern "C"
