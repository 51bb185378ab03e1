// The fold multiply with its fold product on the int8 tensor cores: a warp
// multiplies its 32 lanes together.
//
// Replaces, for the probes K7 and K10 (micro.cu) and, as the multiplier
// modes MulFoldMma (Fq) and MulFoldMmaOf<FrParams> below, for the fold
// unit's bucket scans, suffix rounds, doublings, complete adds (G1's k_add,
// G2's team add) and both inversion chains (curve_fold.cu), the fold
// product of
// vote_saver_tpu/ops/fold_mul.py:fold_columns inside FqEmitFold
// (vote_saver_tpu/ops/pallas_field.py:187-224): there the pieces of every
// lane's product columns go through ONE bf16 dot_general against the
// constant fold matrix, which rides the TPU's matrix unit.  The other steps
// are MulFold's (mul_modes.cuh), unchanged: 8-bit digits, product columns as
// exact fp32 FMAs, three byte pieces a column; after the product the byte
// carry pass, two 16-bit Montgomery word steps and the conditional subtract
// (fold_finish).  The limbs equal MulFold's, lane for lane.
//
// What bounds it on this card: the fp32 FMAs of the digit columns (Fq 48 x
// 48 = 2,304, Fr 32 x 32 = 1,024 a multiply) at one warp instruction a
// clock per SM sub-partition, the issue rate, so every other instruction of
// the multiply costs an issue slot beside them.  MulFold's per-lane fold
// spent 3,744 dp4a (Fq; Fr 1,728) at half rate and kept its 52 (36)
// accumulators live beside the 96 (64) digits.
//
// What the design does about it: the fold product leaves the lane.  Fq's
// sizes below, Fr's in brackets.
//   1. Each thread computes its lane's columns as MulFold does, but starts
//      every FMA chain at 2^23, so a column's float bits are 0x4B000000 plus
//      the column (< 2^22): no conversion, and __byte_perm takes the three
//      low bytes.  Four columns pack into three words, stored 16 bytes at a
//      time into the lane's row of the warp's A tile in shared memory: 32
//      rows x K = 288 [192] bytes (285 [189] pieces, zero padding), row
//      r = 3c + t.
//   2. The block copies the B operand (fold_mul.mma_operand: N = 56 [40]
//      output bytes x K, K contiguous, padding zero) from global memory into
//      shared memory once, at its start.
//   3. The warp multiplies its tile: 2 (m16) x 7 [5] (n8) x 9 [6] (k32) =
//      126 [60] mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32, the pieces
//      unsigned bytes, the matrix balanced signed bytes (a .s8 A would
//      misread pieces >= 128); every sum is below 285 * 255 * 128 < 2^24,
//      exact in s32.  ldmatrix loads the A and B fragments; k runs
//      outermost, so each B fragment serves both m16 tiles and the 56 [40]
//      accumulators are the only state besides the lane's chains.
//   4. The 32 x N s32 accumulator tile goes back through the same shared
//      memory; each thread reads its lane's 52 [36] coefficients and
//      finishes.
// Shared memory, against bank conflicts: A and B rows are K + 16 = 304
// [208] bytes (76 [52] words: 4 times an odd number, so rows 0-7 start on
// 8 distinct multiples of 4 words mod 32): the 8 rows an ldmatrix phase or a
// quarter warp's 16-byte stores touch fall on 8 disjoint groups of 4 banks.
// The C tile's rows are N = 56 [40] words (24 [8] mod 32, so rows 0-3 start
// on 4 distinct groups of 8 banks and rows 4-7 on the same 4), with the
// 4-word chunks of rows whose bit 2 is set swapped in pairs (word ^ 4): the
// 16-byte reads of 8 consecutive rows and the 8-byte fragment stores of a
// half warp are then conflict-free.  A warp's C tile reuses its A tile.
//
// The caller keeps all 32 threads of the warp converged through the multiply
// (mma.sync and ldmatrix are .sync.aligned): a thread past the kernel's n
// computes on a valid lane's data and skips its store.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mul_modes.cuh"

template <class P>
struct FoldMma {
  using G = FoldGeom<P>;
  static constexpr int K = (G::ROWS + 31) / 32 * 32;  // pieces, padded to k32 steps (Fq 288, Fr 192)
  static constexpr int N = (G::NBYTES + 7) / 8 * 8;   // output bytes, padded to n8 tiles (Fq 56, Fr 40)
  static constexpr int KSTEPS = K / 32, NTILES = N / 8;
  static constexpr int ROW = K + 16;                  // bytes a row of the A and B tiles
  static constexpr int GROUPS = (G::NCOLS + 3) / 4;   // four columns make three words
  static constexpr int A_BYTES = 32 * ROW, C_BYTES = 32 * N * 4;
  static constexpr int WARP_BYTES = A_BYTES > C_BYTES ? A_BYTES : C_BYTES;
  static constexpr int B_BYTES = N * ROW;
  // dynamic shared memory of a block of `threads`
  static constexpr int smem_bytes(int threads) { return B_BYTES + threads / 32 * WARP_BYTES; }
  static_assert(12 * GROUPS == K, "the packed pieces fill the padded row");
  static_assert(NTILES % 2 == 1, "the C tile's swizzle needs N = 8 (mod 16)");
  static_assert(ROW % 16 == 0 && (ROW / 4) % 8 == 4, "8 rows' 16-byte chunks on disjoint groups of banks");
  static_assert(G::NBYTES % 4 == 0, "the coefficients are read 16 bytes at a time");
};

// The B operands (fold_mul.mma_operand: N rows of K bytes) of Fq and Fr,
// filled once per loaded library by fold_mma_upload.
__device__ uint4 kFoldMmaFq[FoldMma<FqParams>::N * FoldMma<FqParams>::K / 16];
__device__ uint4 kFoldMmaFr[FoldMma<FrParams>::N * FoldMma<FrParams>::K / 16];

// Host: copy the B operand of field 0 (Fq) or 1 (Fr) into this translation
// unit's device memory; a cudaError_t, 0 on success.
static inline int fold_mma_upload(int field, const void* bytes, long long nbytes) {
  if (field == 0 && (size_t)nbytes == sizeof(kFoldMmaFq)) {
    return (int)cudaMemcpyToSymbol(kFoldMmaFq, bytes, (size_t)nbytes);
  }
  if (field == 1 && (size_t)nbytes == sizeof(kFoldMmaFr)) {
    return (int)cudaMemcpyToSymbol(kFoldMmaFr, bytes, (size_t)nbytes);
  }
  return (int)cudaErrorInvalidValue;
}

// Host: let kernel fn take `smem` bytes of dynamic shared memory a block,
// which above 48 KB it may only after this call, on the current device; a
// cudaError_t, 0 on success.
static inline int allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Host: what the CUDA runtime reports of kernel fn launched with `threads`
// threads and `smem` bytes of dynamic shared memory a block on the current
// device: out = {registers a thread, local (spill and stack) bytes a
// thread, shared memory a block (`smem` and the kernel's static shared
// memory), resident blocks a SM, threads a block}; a cudaError_t, 0 on
// success.
static inline int kernel_info(const void* fn, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  int err = allow_smem(fn, smem);
  if (err == 0) err = (int)cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == 0) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, (size_t)smem);
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem + (int)attr.sharedSizeBytes;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}

// Field P's B operand in this unit's device memory.
template <class P>
__device__ __forceinline__ const uint4* fold_mma_b();

template <>
__device__ __forceinline__ const uint4* fold_mma_b<FqParams>() {
  return kFoldMmaFq;
}

template <>
__device__ __forceinline__ const uint4* fold_mma_b<FrParams>() {
  return kFoldMmaFr;
}

// The block's copy of field P's B operand into rows of ROW bytes at sb; the
// caller synchronises the block after it.
template <class P>
__device__ __forceinline__ void fold_mma_load_b(uint8_t* sb) {
  using F = FoldMma<P>;
  constexpr int CHUNKS = F::K / 16;
  const uint4* b = fold_mma_b<P>();
  for (int q = threadIdx.x; q < F::N * CHUNKS; q += blockDim.x) {
    *reinterpret_cast<uint4*>(sb + (q / CHUNKS) * F::ROW + 16 * (q % CHUNKS)) = b[q];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 32 unsigned bytes, row) * b (32 x 8 signed bytes, col)
__device__ __forceinline__ void mma_u8s8(int32_t (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a * b * R^-1 mod N, canonical, for this thread's lane; every thread of the
// warp calls it together.  sb: the block's B operand (fold_mma_load_b);
// tile: the warp's WARP_BYTES of shared memory, 16-byte aligned.
template <class P>
__device__ __forceinline__ Fp<P> mul_fold_mma(const Fp<P>& a, const Fp<P>& b, const uint8_t* sb, uint8_t* tile) {
  using G = FoldGeom<P>;
  using F = FoldMma<P>;
  const int lane = threadIdx.x & 31;
  // 1. digits, exact in fp32
  float da[G::ND], db[G::ND];
#pragma unroll
  for (int k = 0; k < G::ND; ++k) {
    da[k] = (float)((a.v[k / 4] >> (8 * (k % 4))) & 0xFFu);
    db[k] = (float)((b.v[k / 4] >> (8 * (k % 4))) & 0xFFu);
  }
  // 2.-3. column c (< 2^22, exact fp32 FMAs from 2^23) -> its three pieces,
  // bytes 3c..3c+2 of this lane's row of the A tile
  uint8_t* row = tile + lane * F::ROW;
  uint32_t v[4], w[3 * F::GROUPS];
#pragma unroll
  for (int c = 0; c < G::NCOLS; ++c) {
    float col = 8388608.f;
#pragma unroll
    for (int i = 0; i < G::ND; ++i) {
      if (c - i >= 0 && c - i < G::ND) col = fmaf(da[i], db[c - i], col);
    }
    v[c % 4] = __float_as_uint(col);
    if (c % 4 == 3 || c == G::NCOLS - 1) {
#pragma unroll
      for (int k = c % 4 + 1; k < 4; ++k) v[k] = 0;  // past the last column: zero pieces
      const int q = c / 4;
      w[3 * q] = __byte_perm(v[0], v[1], 0x4210);      // c0.b0 c0.b1 c0.b2 c1.b0
      w[3 * q + 1] = __byte_perm(v[1], v[2], 0x5421);  // c1.b1 c1.b2 c2.b0 c2.b1
      w[3 * q + 2] = __byte_perm(v[2], v[3], 0x6542);  // c2.b2 c3.b0 c3.b1 c3.b2
#pragma unroll
      for (int k = 3 * q; k < 3 * q + 3; ++k) {
        if (k % 4 == 3) {
          *reinterpret_cast<uint4*>(row + 4 * (k - 3)) = make_uint4(w[k - 3], w[k - 2], w[k - 1], w[k]);
        }
      }
    }
  }
  __syncwarp();
  // 4. the fold product: acc[m][j] is rows 16m.., output bytes 8j..
  int32_t acc[2][F::NTILES][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < F::NTILES; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0;
  }
  // ldmatrix rows: A's x4 takes rows 0-15 at bytes 0 and 16 of a k-step,
  // B's x2 rows 8j..8j+7 at bytes 0 and 16
  const uint32_t a_at = smem_u32(tile) + (lane & 15) * F::ROW + (lane >> 4) * 16;
  const uint32_t b_at = smem_u32(sb) + (lane & 7) * F::ROW + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int s = 0; s < F::KSTEPS; ++s) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_at + 32 * s);
    ldsm_x4(a1, a_at + 16 * F::ROW + 32 * s);
#pragma unroll
    for (int j = 0; j < F::NTILES; ++j) {
      uint32_t bf[2];
      ldsm_x2(bf, b_at + 8 * j * F::ROW + 32 * s);
      mma_u8s8(acc[0][j], a0, bf);
      mma_u8s8(acc[1][j], a1, bf);
    }
  }
  __syncwarp();
  // the accumulator fragments (rows g and g + 8 of each m16 tile, bytes
  // 2t, 2t + 1 of each n8 tile) into the C tile, word ^ 4 in rows with bit 2
  int32_t* ct = reinterpret_cast<int32_t*>(tile);
  const int gid = lane >> 2, tig = lane & 3, swz = gid & 4;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < F::NTILES; ++j) {
      const int col = (8 * j + 2 * tig) ^ swz;
      *reinterpret_cast<int2*>(ct + (16 * m + gid) * F::N + col) = make_int2(acc[m][j][0], acc[m][j][1]);
      *reinterpret_cast<int2*>(ct + (16 * m + gid + 8) * F::N + col) = make_int2(acc[m][j][2], acc[m][j][3]);
    }
  }
  __syncwarp();
  int32_t g[G::NBYTES];
  const int32_t* mine = ct + lane * F::N;
#pragma unroll
  for (int q = 0; q < G::NBYTES / 4; ++q) {
    const int4 t = *reinterpret_cast<const int4*>(mine + ((4 * q) ^ (lane & 4)));
    g[4 * q] = t.x;
    g[4 * q + 1] = t.y;
    g[4 * q + 2] = t.z;
    g[4 * q + 3] = t.w;
  }
  __syncwarp();  // the tile is free for the next multiply's pieces
  // 5.-6.
  return fold_finish<P>(g);
}

// The tensor-core fold as a multiplier mode (mul_modes.cuh), for kernels
// written over a mode, in the field P of the B operand its blocks hold.  Its
// shared memory is the block's dynamic shared memory, smem_bytes(threads)
// of it: the B operand at offset 0, warp w's tile at B_BYTES + w *
// WARP_BYTES.  The prologue copies the B operand into it and synchronises
// the block, so every thread of the block runs it before any thread exits.
// kConverged: every thread of a warp calls mul together (a kernel's
// converged form, curve_kernels.cuh).
template <class P>
struct MulFoldMmaOf {
  using F = FoldMma<P>;
  static constexpr bool kConverged = true;
  static constexpr int smem_bytes(int threads) { return F::smem_bytes(threads); }

  __device__ static __forceinline__ uint8_t* smem() {
    extern __shared__ __align__(16) uint8_t vs_fold_mma_smem[];
    return vs_fold_mma_smem;
  }

  // warp w's tile, which is free between multiplies: a kernel may pass
  // values between its warps through it (jac_double_warps, curve.cuh)
  __device__ static __forceinline__ uint8_t* warp_tile(int w) { return smem() + F::B_BYTES + w * F::WARP_BYTES; }

  __device__ static __forceinline__ void prologue() {
    fold_mma_load_b<P>(smem());
    __syncthreads();
  }

  template <class Q>
  __device__ static __forceinline__ Fp<Q> mul(const Fp<Q>& a, const Fp<Q>& b) {
    static_assert(std::is_same<Q, P>::value, "the block holds the B operand of another field");
    return mul_fold_mma<Q>(a, b, smem(), warp_tile(threadIdx.x >> 5));
  }
};

// The Fq mode of the curve kernels, a type of its own so that its kernels
// keep their names.  Through Called<MulFoldMma> the multiply is one
// out-of-line copy a kernel, as every G1 multiply of the curve kernels is;
// a G2 kernel over MulFoldMma calls it out of line through its Fq2
// multiply (fq_mul_call).  The G2 team add and the Fq inversion chain take
// MulFoldMma itself, the Fr inversion chain MulFoldMmaOf<FrParams>, their
// multiplies inlined.
struct MulFoldMma : MulFoldMmaOf<FqParams> {};
