// The curve kernels K2-K6, K3d and K1's Fermat chain in the fold
// multiplier mode, their extern "C" launchers and the unit's fold-matrix
// uploads.
//
// Replaces the same pallas_calls as their loop instances (curve_kernels.cuh,
// add_team.cuh), compiled with VSTPU_MUL=fold: every Fq and Fr multiply of
// the formulas and the inversion chains through FqEmitFold (pallas_field.py
// l.187-224, with the fold matrix as the kernel's extra input, _fold_inputs
// l.286-298): fp32 digit columns, the reduction as one product with the
// constant matrix, two 16-bit word steps and a conditional subtract.  Two
// forms of that product:
//
//   * the bucket scan (k_madd_scan), the suffix round (k_add_shift) and
//     the doubling (k_double) of both groups, the complete adds of both
//     groups (k_add in G1, the team add k_add_team in G2) and both
//     inversion chains (k_mont_inv): Called<MulFoldMma> (fold_mma.cuh) in
//     G1, MulFoldMma in G2, whose Fq2 multiply calls it out of line
//     (fq_mul_call; the team add multiplies Fq values and inlines it), and
//     in the Fq chain, MulFoldMmaOf<FrParams> in the Fr chain; the product
//     a warp's 32 lanes at once as 126 (Fr: 60) mma.sync on the int8 tensor
//     cores, the B operands in this unit's device memory (kFoldMmaFq,
//     kFoldMmaFr), copied into each block's shared memory by the kernel's
//     prologue.  What bounds a multiply there: the 2,304 (Fr: 1,024) fp32
//     FMAs of the digit columns, one issue slot each.  The ten kernels run
//     in their converged form (curve_kernels.cuh, add_team.cuh).
//   * every other kernel (the single-row madd, the distinct and flagged
//     adds, setup's window sum), none of them on the vote path: MulFold (mul_modes.cuh), the
//     product as 72 x 52 dp4a a lane against the matrix in this unit's
//     __constant__ memory; bound by the 2,304 FMAs and those 3,744 dp4a
//     with their constant reads, one lane at a time.
//
// The matrices live in this unit's own memory (kFoldFq in __constant__,
// which every dp4a instance here reads, all of them Fq's; kFoldMmaFq and
// kFoldMmaFr): vs_curve_fold_upload and vs_curve_fold_mma_upload fill them,
// once per field, library and card, before the unit's first launch there
// (hopper_field.upload_fold_matrix; the wrappers call it).  The B operands' upload also lifts the tensor-core
// instances' limit of dynamic shared memory on the card, once, so their
// launches need no attribute call.  Launchers: curve_unit.cuh,
// each named as its loop launcher with `_fold`.  The G1 multiply is called,
// not inlined: inlined, the scan took 70.75 ms a call against 45.4-45.5
// and the doubling at 16 lanes x 10 2.2x as long (PERF.md).

#include "fold_mma.cuh"

#define VS_MODE MulFold
#define VS_SUFFIX _fold
#define VS_MODE_G1_MMA Called<MulFoldMma>
#define VS_MODE_G2_MMA MulFoldMma
#define VS_MODE_FQ_MMA MulFoldMma
#define VS_MODE_FR_MMA MulFoldMmaOf<FrParams>
#include "curve_unit.cuh"

namespace {

// the tensor-core instances, in the order of hopper_field.MMA_KERNELS, each
// with its dynamic shared memory a block (the G2 scan's also holds its
// parked accumulators, curve_kernels.cuh); a missing entry leaves its
// launch refused above 48 KB
struct MmaKernel {
  const void* fn;
  int smem;
};

const MmaKernel kMmaKernels[] = {
    {reinterpret_cast<const void*>(k_madd_scan<Fq, ModeG1Mma>), kScanSmem<Fq, ModeG1Mma>},
    {reinterpret_cast<const void*>(k_double<Fq, ModeG1Mma>), ModeG1Mma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_add_shift<Fq, ModeG1Mma>), ModeG1Mma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_double<Fq2, ModeG2Mma>), ModeG2Mma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_madd_scan<Fq2, ModeG2Mma>), kScanSmem<Fq2, ModeG2Mma>},
    {reinterpret_cast<const void*>(k_add_shift<Fq2, ModeG2Mma>), ModeG2Mma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_add<Fq, ModeG1Mma>), ModeG1Mma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_mont_inv<FrParams, ModeFrMma>), ModeFrMma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_mont_inv<FqParams, ModeFqMma>), ModeFqMma::smem_bytes(kThreads)},
    {reinterpret_cast<const void*>(k_add_team<AddTeamG2, ModeG2Mma>), ModeG2Mma::smem_bytes(kThreads)},
};

// kernel_info and the launches size a block alike: kThreads threads
static_assert(kTeam * kTeamsOf<ModeG2Mma> == kThreads, "the team add's converged block is kThreads");

}  // namespace

extern "C" {

// words: ops/fold_mul.packed_matrix of the field (0 = Fq, 1 = Fr), nwords
// int32 words.
int vs_curve_fold_upload(int field, const void* words, long long nwords) {
  return fold_upload(field, words, nwords);
}

// bytes: ops/fold_mul.mma_operand of Fq (field 0) or Fr (field 1), nbytes
// long.  Also lets the tensor-core instances take their dynamic shared
// memory on the current device.
int vs_curve_fold_mma_upload(int field, const void* bytes, long long nbytes) {
  int err = fold_mma_upload(field, bytes, nbytes);
  for (const MmaKernel& k : kMmaKernels) {
    if (err == 0) err = allow_smem(k.fn, k.smem);
  }
  return err;
}

// What the CUDA runtime reports of tensor-core instance `kernel`
// (kMmaKernels) on the current device: fold_mma.cuh's kernel_info.
int vs_curve_fold_mma_info(int kernel, int* out) {
  if (kernel < 0 || kernel >= (int)(sizeof(kMmaKernels) / sizeof(kMmaKernels[0]))) {
    return (int)cudaErrorInvalidValue;
  }
  return kernel_info(kMmaKernels[kernel].fn, kThreads, kMmaKernels[kernel].smem, out);
}

}  // extern "C"
