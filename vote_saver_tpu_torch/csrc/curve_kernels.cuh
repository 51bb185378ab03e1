// The curve kernels K2-K6, K3d and K1's Fermat chain as templates over the
// multiplier mode, with one launch function per kernel family.
//
//   k_mont_inv<P, M>  <- pallas_field._mul_call (call l.786), repeated by
//                        field_ops.FieldOps.inv's lax.scan: the whole Fermat
//                        inversion in one launch
//   K2 k_madd<E, M>   <- pallas_field._g1_madd_call / _g2_madd_call
//      k_madd_scan<E, M> <- the same call, repeated by msm_sched._msm_device's
//                        lax.scan over schedule rows: the bucket scan in one
//                        launch
//   K3 k_add<Fq, M>   <- pallas_field._g1_add_call (complete); G2's
//                        _g2_add_call is add_team.cuh's team kernel
//      k_add_shift<E, M> <- the same call in _suffix_and_total's rounds, with
//                        the roll and select of its partner inside
//   K3d k_add_distinct<E, M> <- _g1_add_call / _g2_add_call with
//                        complete=False, reached through
//                        JacobianOps.add_distinct by FixedBaseTable.mul's
//                        window sum, i.e. by Groth16 setup on the device
//   K4 k_double<E, M> <- pallas_field._g1_dbl_call / _g2_dbl_call, with a
//                        count: the fori_loop of doublings that msm_sched's
//                        _horner and curve_ops' scalar_mul_windowed wrap
//                        around the call, in one launch
//   K5/K6 k_addx<E, M> <- pallas_field._g1_addx_call / _g2_addx_call: the
//                        distinct add plus the per-lane doubling-corner flag,
//                        reached through msm_sched._addx(group, distinct=True)
//                        by the MSM combination phase
//
// Each Pallas wrapper takes the multiplier mode that VSTPU_MUL names
// (pallas_field._mul_mode, l.274; emitters chosen at l.278-283); here the
// mode is the template parameter M (mul_modes.cuh), and each unit
// instantiates every kernel in one mode: kernels.cu and add_distinct.cu in
// loop, curve_v1.cu in v1, curve_fold.cu in fold.  A G1 kernel takes
// Called<M> (one out-of-line copy of the mode's multiply; the loop
// instances of K3d and K5/K6 take MulLoop inlined), a G2 kernel M, whose
// Fq2 multiply calls its Fq multiply out of line (fq_mul_call).  The fold
// unit's bucket scan, suffix round and doubling take Called<MulFoldMma> in
// G1 and MulFoldMma in G2, its G1 complete add Called<MulFoldMma> and its
// Fr inversion chain MulFoldMmaOf<FrParams>: the fold product on the int8
// tensor cores (fold_mma.cuh).
//
// The converged form.  A mode whose multiply a warp runs together
// (M::kConverged: mma.sync and ldmatrix are .sync.aligned) needs every
// thread of a warp at each multiply.  k_mont_inv, k_madd_scan, k_add,
// k_add_shift and k_double take this form for such a mode (if constexpr;
// the other modes' code is the one form they had): every thread of the
// block runs M::prologue() first; then a warp whose lanes are all past n
// exits, and a thread past n inside a live warp computes on lane n - 1's
// data (lane_in) and skips its stores; the scan's madd is jac_madd_select
// and the adds jac_add_select (curve.cuh: every multiply on every lane,
// then selects) instead of jac_madd's early returns and jac_add's
// branches.  The branches left before a multiply (scan_point's idle code;
// the warp-uniform skips of k_add_shift and jac_add_select, the
// block-uniform one of jac_add_warps) end before the multiply, and
// mul_fold_mma synchronises the warp (__syncwarp) between its pieces and
// its product.  The launchers pass M::smem_bytes(kThreads) as the
// launch's dynamic shared memory (0 for the other modes), the scan kScanSmem
// (below); a kernel may take more than 48 KB of it only once the card's
// limit for it is lifted, which the fold unit's B operand upload does
// (curve_fold.cu).
//
// Each is one thread per lane over (B, L) / (B, 2, L) int32 tensors read as
// uint32_t*, with every limb in registers.  The Pallas kernels tile the
// batch into (S, T) vregs and transpose to (L, S, T) around every call; here
// the tensors keep the framework layout, so nothing is repacked per call.
// Bound and design notes: field.cuh (arithmetic), mul_modes.cuh (the
// multiplier modes) and curve.cuh (formulas).  Register use and spills per
// kernel are printed by `nvcc --resource-usage` at build time
// (ops/_build.py keeps the report beside the library).
//
// The launch functions run on the caller's stream, do not synchronise,
// allocate nothing, and return cudaGetLastError() (0 on success).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int32_t kIdxMask = (1 << 30) - 1;

__host__ __forceinline__ unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Converged form: true where the thread's whole warp is past n (else where
// the thread is), and the lane a thread computes on.
template <class M>
__device__ __forceinline__ bool past_end(long long i, long long n) {
  if constexpr (M::kConverged) {
    return i - (threadIdx.x & 31) >= n;
  } else {
    return i >= n;
  }
}

template <class M>
__device__ __forceinline__ long long lane_in(long long i, long long n) {
  if constexpr (M::kConverged) {
    return i < n ? i : n - 1;
  } else {
    return i;
  }
}

// a^(N - 2) = a^-1 for canonical a != 0 (0 maps to 0), by square-and-multiply
// over the bits of N - 2, MSB first, as FieldOps.inv scans them; the top bit
// seeds the result with a itself.  Fr: 254 squares + 163 multiplies, Fq:
// 380 + 228, all on the mode's multiply (loop: K1's CIOS body inlined) with
// the state in registers; one load and one store per lane.
//
// What bounds it on the main path: latency.  The callers invert 16 lanes
// (the device witness, one per voter) to a few hundred (the ballot tail's
// affine conversion): one to four warps on 132 SMs, each running 417 (Fr)
// or 608 (Fq) dependent multiplies.  Before this kernel each multiply was a
// launch of its own, and the chain cost its launches, not its arithmetic.
// A fixed 4-bit window would cut the multiplies to about 64 / 97, but its
// 16-entry table (128 / 192 registers) would spill, so the binary chain was
// built: it keeps the registers of k_mont_mul.  The next step is to split
// one lane's multiply across threads (limb products spread over a warp,
// carries by shuffles), so that a chain of 16 lanes fills more than one
// warp's issue slots.
//
// In a converged mode (the fold unit's Fr instance, MulFoldMmaOf<FrParams>:
// each multiply's fold product a warp's tile on the tensor cores, 60
// mma.sync against the block's copy of Fr's B operand) the prologue runs
// first, whole warps past n leave and a ragged warp's spare threads compute
// on lane n - 1 and store nothing; the exponent's bits are the same on
// every lane, so the chain is warp-uniform as it stands.  At the device
// witness's 16 lanes it is one warp, 2.0 us a multiply (0.83 ms a chain,
// against the dp4a fold's 2.67): the 1,024 digit FMAs are not what holds
// it, since four warps sharing one tile, each a quarter of the columns,
// took as long (PERF.md); the serial carry chain of fold_finish is.
template <class P, class M>
__global__ void __launch_bounds__(kThreads)
    k_mont_inv(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  M::prologue();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (past_end<M>(t, n)) return;
  const long long i = lane_in<M>(t, n);
  Fp<P> x;
  load(x, a, i);
  Fp<P> r = x;
#pragma unroll 1
  for (int k = P::NM2_BITS - 2; k >= 0; --k) {
    r = M::mul(r, r);
    if ((P::nm2(k >> 5) >> (k & 31)) & 1u) r = M::mul(r, x);
  }
  if constexpr (M::kConverged) {
    if (t >= n) return;
  }
  store(out, i, r);
}

// In-place safe: every lane reads all of its inputs before it writes.
template <class E, class M>
__global__ void __launch_bounds__(kThreads)
    k_madd(const uint32_t* ax, const uint32_t* ay, const uint32_t* az,
           const uint32_t* qx, const uint32_t* qy, const uint8_t* sign,
           const uint8_t* active, uint32_t* ox, uint32_t* oy, uint32_t* oz,
           int32_t* exc, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> acc;
  E x2, y2;
  load(acc.x, ax, i);
  load(acc.y, ay, i);
  load(acc.z, az, i);
  load(x2, qx, i);
  load(y2, qy, i);
  const uint32_t e = jac_madd<E, M>(acc, x2, y2, sign[i] != 0, active[i] != 0);
  store(ox, i, acc.x);
  store(oy, i, acc.y);
  store(oz, i, acc.z);
  exc[i] = (int32_t)e;
}

// K3 in G1, complete.  What bounds it on the vote path: latency.  Its
// callers (the MSM's orphan merges and Horner steps, the ballot tail) add
// 16-480 lanes a launch: one to four blocks on 132 SMs, each lane a chain
// of 16 dependent Fq multiplies.  In a converged mode (the fold unit's
// instance, Called<MulFoldMma>: each multiply's fold product a warp's tile
// on the tensor cores) a block of 128 threads holds 32 lanes, its 4 warps
// the same ones, and shares each add's products over them, 4 a round
// (jac_add_warps, curve.cuh): a chain of 5 multiplies, the doubling
// corner's 3 more only in a block where a lane needs them; a ragged
// block's spare lanes compute on lane n - 1, and warp 0 stores.  The
// prologue runs before anything else.  It ran faster than one thread a
// lane running jac_add_select at every width measured, 16 to 2^14 lanes
// (PERF.md), so it is the converged form at every width.
template <class E, class M>
__global__ void __launch_bounds__(kThreads)
    k_add(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
          const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
          uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  if constexpr (M::kConverged) {
    static_assert(std::is_same<E, Fq>::value, "k_add's converged form is G1's");
    M::prologue();
    const long long t = (long long)blockIdx.x * 32 + (threadIdx.x & 31);
    const long long i = lane_in<M>(t, n);
    Jac<Fq> p, q;
    load(p.x, px, i);
    load(p.y, py, i);
    load(p.z, pz, i);
    load(q.x, qx, i);
    load(q.y, qy, i);
    load(q.z, qz, i);
    const Jac<Fq> r = jac_add_warps<M>(p, q);
    if (t >= n || threadIdx.x >= 32) return;
    store(ox, i, r.x);
    store(oy, i, r.y);
    store(oz, i, r.z);
  } else {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Jac<E> p, q;
    load(p.x, px, i);
    load(p.y, py, i);
    load(p.z, pz, i);
    load(q.x, qx, i);
    load(q.y, qy, i);
    load(q.z, qz, i);
    const Jac<E> r = jac_add<E, M>(p, q);
    store(ox, i, r.x);
    store(oy, i, r.y);
    store(oz, i, r.z);
  }
}

// The affine point `code` names in the table, or (0, 0) for an idle code.
// The wrapper (hopper_field._madd_scan) has checked that every code names a
// point of the table.
template <class E>
__device__ __forceinline__ void scan_point(int32_t code, const uint32_t* __restrict__ px,
                                           const uint32_t* __restrict__ py, E& x, E& y) {
  if (code == 0) {
    x = zero_of<E>();
    y = zero_of<E>();
    return;
  }
  const long long k = max((code & kIdxMask) - 1, 0);
  load_ro(x, px, k);
  load_ro(y, py, k);
}

// The converged G2 scan parks its accumulator in the block's shared memory
// (ParkedJac, curve.cuh), after the mode's.  With every Fq2 product a call
// of fq_mul_call, the accumulator held in registers across the calls went
// to the thread's stack (1,312 B of local memory a thread at 168
// registers, 12 warps a SM); parked, the scan ran 25% faster at the vote
// path's schedule though its 92,800 B a block leave 8 warps a SM.  The
// suffix round's partner parked the same way ran 1-2% slower (it had 8
// warps a SM already), so the round keeps its operands in registers
// (PERF.md).  The sizes are constexpr variables, which device code may
// read.
template <class M>
constexpr int kModeSmem = M::smem_bytes(kThreads);
template <class E, class M>
constexpr bool kScanParks = M::kConverged && std::is_same<E, Fq2>::value;
template <class E, class M>
constexpr int kScanSmem = kModeSmem<M> + (kScanParks<E, M> ? kThreads * (int)sizeof(Jac<E>) : 0);

// A scan lane's accumulator, canonical infinity: parked, or in registers.
template <class E, class M>
__device__ __forceinline__ auto scan_acc() {
  if constexpr (kScanParks<E, M>) {
    uint32_t* area = reinterpret_cast<uint32_t*>(M::smem() + kModeSmem<M>);
    ParkedJac<E> acc{area + threadIdx.x, kThreads};
    put(acc, jac_infinity<E>());
    return acc;
  } else {
    return jac_infinity<E>();
  }
}

// K2's bucket scan: the whole (steps, lanes) schedule in one launch.  Each
// thread owns one bucket lane: it starts from canonical infinity (1, 1, 0),
// keeps the Jacobian accumulator and the OR of its doubling-corner flags in
// registers across every row, and writes both once.  Row s: code =
// codes[s, lane] (0 idle, else (pidx + 1) | sign << 30), the affine point
// pidx read from the table, jac_madd as k_madd runs it.  Each lane runs the
// same madds in the same order as one k_madd launch per row, so the limbs
// and exc are those of the row loop (msm_sched.bucket_phase before the scan).
//
// What bounds it: the madd's 11 Fq multiplies (G1; G2 29) per entry, as in
// k_madd.  What it removes: per row and lane, k_madd read and wrote the
// 144 B (G1) accumulator and read a 96 B point that an index_select had
// gathered and written, and each row paid a launch plus five decode ops and
// two gathers.  Here a row costs a 4 B coalesced code and a read of the
// point table (at most 2^15 points: 3.1 MB in G1, 6.3 MB in G2), which
// stays in L2.  Row s + 1's loads are issued before row s's multiplies, so
// their L2 latency hides behind the arithmetic, at the cost of a second
// point in registers (G1 198 registers against 194 without; 1-4% faster on
// the card at the vote path's schedules, PERF.md).
//
// In a converged mode (the fold unit's G1 and G2 instances, 7,776 warps at
// the vote path's 248,832 lanes) each madd is jac_madd_select, the rows
// run on every thread of a live warp, and row s's point is read after row
// s - 1's madd: without the prefetch the converged G1 scan ran 0.5-0.7%
// faster at the vote path's schedule, with a third of the spill stores
// (PERF.md).  There the lane's multiplies are the fp32 digit columns and
// the tail of mul_fold_mma, the fold product a warp's tile on the tensor
// cores (G2: 29 such multiplies a madd, each a call of fq_mul_call, and
// the accumulator parked in shared memory, above).
template <class E, class M>
__global__ void __launch_bounds__(kThreads)
    k_madd_scan(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                const int32_t* __restrict__ codes, int steps, long long lanes, uint32_t* ox,
                uint32_t* oy, uint32_t* oz, int32_t* exc) {
  M::prologue();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (past_end<M>(t, lanes)) return;
  const long long i = lane_in<M>(t, lanes);
  auto acc = scan_acc<E, M>();
  uint32_t e = 0u;
  int32_t code = steps > 0 ? __ldg(codes + i) : 0;
  E x2, y2;
  scan_point(code, px, py, x2, y2);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int32_t next = s + 1 < steps ? __ldg(codes + (long long)(s + 1) * lanes + i) : 0;
    E nx, ny;
    if constexpr (!M::kConverged) scan_point(next, px, py, nx, ny);
    if constexpr (M::kConverged) {
      e |= jac_madd_select<E, M>(acc, x2, y2, ((code >> 30) & 1) != 0, code != 0);
    } else {
      e |= jac_madd<E, M>(acc, x2, y2, ((code >> 30) & 1) != 0, code != 0);
    }
    code = next;
    if constexpr (!M::kConverged) {
      x2 = nx;
      y2 = ny;
    } else {
      scan_point(code, px, py, x2, y2);
    }
  }
  if constexpr (M::kConverged) {
    if (t >= lanes) return;
  }
  store(ox, i, jx(acc));
  store(oy, i, jy(acc));
  store(oz, i, jz(acc));
  exc[i] = (int32_t)e;
}

// K3 in the form the MSM's suffix rounds run it: over the (rows, bw) bucket
// grid flattened to n = rows * bw lanes,
//   out[w, b] = add(in[w, b], b + shift < bw ? in[w, b + shift] : infinity)
// with the complete jac_add; a lane with no partner keeps in[w, b], or
// becomes canonical infinity (1, 1, 0) if it is infinite, which is what
// jac_add(p, infinity) gives.  The partner is read here, so a round runs no
// roll or select before it and allocates nothing (the caller ping-pongs two
// buffers; out must not alias in).
//
// Each round stays one launch (9 a pass, 18 per MSM): a form that ran all
// rounds in one launch would hold a window's 512 partial sums (72 KB in G1,
// 147 KB in G2) between rounds behind a block-wide barrier, and at this
// kernel's 234 registers (G1 loop; G2 255 and 1,520 B of spill stores,
// ptxas) a block of 512 threads would need 119,808 of the SM's 65,536.
//
// In a converged mode (the fold unit's G1 and G2 instances: 6,912 warps a
// round at 432 x 512, so bound by the multiplies' issue, not by latency;
// G2's add is 43 Fq multiplies, its doubling 16 more) no lane
// branches on its partner: a lane with none takes canonical infinity as q,
// and jac_add_select(p, infinity) gives p, or (1, 1, 0) where p is
// infinite, as the other form's else arm does.  A warp none of whose lanes
// has a partner (b >= bw - shift for all 32: shift / 32 of a row's bw / 32
// warps at shift >= 32 with bw a multiple of 32) skips the add as a whole,
// a warp-uniform test; the add computes the doubling only where a lane of
// the warp has equal operands, which empty bucket ranges make adjacent
// partial sums have (msm_sched._suffix_and_total).
template <class E, class M>
__global__ void __launch_bounds__(kThreads)
    k_add_shift(const uint32_t* px, const uint32_t* py, const uint32_t* pz, uint32_t* ox,
                uint32_t* oy, uint32_t* oz, long long n, int bw, int shift) {
  if constexpr (M::kConverged) {
    M::prologue();
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (past_end<M>(t, n)) return;
    const long long i = lane_in<M>(t, n);
    const bool partner = (long long)(i % bw) + shift < bw;
    const long long k = partner ? i + shift : i;
    Jac<E> p, q;
    load(p.x, px, i);
    load(p.y, py, i);
    load(p.z, pz, i);
    load(q.x, px, k);
    load(q.y, py, k);
    load(q.z, pz, k);
    const Jac<E> inf = jac_infinity<E>();
    q = {sel(partner, q.x, inf.x), sel(partner, q.y, inf.y), sel(partner, q.z, inf.z)};
    Jac<E> r;
    if (__any_sync(0xffffffffu, partner)) {
      r = jac_add_select<E, M>(p, q);
    } else {
      const bool p_inf = is_zero(p.z);
      r = {sel(p_inf, inf.x, p.x), sel(p_inf, inf.y, p.y), sel(p_inf, inf.z, p.z)};
    }
    if (t >= n) return;
    store(ox, i, r.x);
    store(oy, i, r.y);
    store(oz, i, r.z);
  } else {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Jac<E> p;
    load(p.x, px, i);
    load(p.y, py, i);
    load(p.z, pz, i);
    Jac<E> r;
    if ((long long)(i % bw) + shift < bw) {
      Jac<E> q;
      load(q.x, px, i + shift);
      load(q.y, py, i + shift);
      load(q.z, pz, i + shift);
      r = jac_add<E, M>(p, q);
    } else {
      r = is_zero(p.z) ? jac_infinity<E>() : p;
    }
    store(ox, i, r.x);
    store(oy, i, r.y);
    store(oz, i, r.z);
  }
}

// `times` >= 1 doublings of each lane, in registers between one load and one
// store.  Canonical infinity (1, 1, 0) doubles to itself through the
// formula, so `times` doublings here give the limbs of `times` launches.
//
// What bounds it on the main path: latency.  Horner's step runs 10
// doublings on `parts` = 16 lanes per MSM, the ballot tail's windowed
// multiplies 4 on 32-480 lanes: 1 to 4 blocks on 132 SMs, each doubling 7
// dependent Fq multiplies (G2: 7 Fq2 products).  One launch per doubling
// paid a launch and a global round trip for each; `times` pays them once
// per chain.  In a converged mode (the fold unit's G1 and G2 instances:
// one to four warps, each a chain of 7 dependent multiplies a doubling in
// G1, 16 Fq multiplies in G2) each multiply's fold product is a warp's tile
// on the tensor cores, the lanes past n of a ragged warp padding rows of
// it.  A G2 launch of at most 32 lanes (the vote path's: Horner's 16, the
// ballot tail's 32) is one block whose three warps past the lanes would
// idle: there all four warps hold the same lanes and share each doubling's
// 16 products, 4 a round (jac_double_warps, curve.cuh), so the chain is 4
// multiplies a doubling, not 16.
template <class E, class M>
__global__ void __launch_bounds__(kThreads)
    k_double(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n, int times) {
  M::prologue();
  if constexpr (M::kConverged && std::is_same<E, Fq2>::value) {
    if (n <= 32) {  // one block, whose 4 warps share each doubling's products
      const int lane = threadIdx.x & 31;
      const long long i = lane < n ? lane : n - 1;
      Jac<E> p;
      load(p.x, px, i);
      load(p.y, py, i);
      load(p.z, pz, i);
#pragma unroll 1
      for (int k = 0; k < times; ++k) p = jac_double_warps<M>(p);
      if (threadIdx.x >= n) return;
      store(ox, i, p.x);
      store(oy, i, p.y);
      store(oz, i, p.z);
      return;
    }
  }
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (past_end<M>(t, n)) return;
  const long long i = lane_in<M>(t, n);
  Jac<E> p;
  load(p.x, px, i);
  load(p.y, py, i);
  load(p.z, pz, i);
#pragma unroll 1
  for (int k = 0; k < times; ++k) p = jac_double<E, M>(p);
  if constexpr (M::kConverged) {
    if (t >= n) return;
  }
  store(ox, i, p.x);
  store(oy, i, p.y);
  store(oz, i, p.z);
}

// K3d.  What bounds it and K5/K6: the 16 field multiplies of the generic add
// (x3 in Fq2 for G2), i.e. integer multiply throughput; they drop the
// complete add's doubling branch, so their register live range is the
// generic formula's alone.
template <class E, class M>
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

// K5/K6: exc[i] = 1 where lane i hit the doubling corner (p = q, both finite)
template <class E, class M>
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

// ---------------------------------------------------------------------------
// Launch functions: the extern "C" launchers of every unit call these, with
// G1's multiplier M1 and G2's M2.  g2: 0 = G1 (Fq coordinates), 1 = G2 (Fq2
// coordinates); field: 0 = Fq, 1 = Fr.
// ---------------------------------------------------------------------------

using u32p = const uint32_t*;

// MQ: the mode of the Fq chain, MR: Fr's.
template <class MQ, class MR>
int launch_mont_inv(int field, const void* a, void* out, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (field == 0) {
    k_mont_inv<FqParams, MQ><<<blocks_for(n), kThreads, MQ::smem_bytes(kThreads), s>>>((u32p)a, (uint32_t*)out, n);
  } else {
    k_mont_inv<FrParams, MR><<<blocks_for(n), kThreads, MR::smem_bytes(kThreads), s>>>((u32p)a, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

template <class M1, class M2>
int launch_madd(int g2, const void* ax, const void* ay, const void* az, const void* qx,
                const void* qy, const void* sign, const void* active, void* ox, void* oy,
                void* oz, void* exc, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_madd<Fq2, M2><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)ax, (u32p)ay, (u32p)az, (u32p)qx, (u32p)qy, (const uint8_t*)sign,
        (const uint8_t*)active, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)exc, n);
  } else {
    k_madd<Fq, M1><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)ax, (u32p)ay, (u32p)az, (u32p)qx, (u32p)qy, (const uint8_t*)sign,
        (const uint8_t*)active, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)exc, n);
  }
  return (int)cudaGetLastError();
}

template <class M1>
int launch_g1_add(const void* px, const void* py, const void* pz, const void* qx, const void* qy,
                  const void* qz, void* ox, void* oy, void* oz, long long n, void* stream) {
  const unsigned blocks = M1::kConverged ? (unsigned)((n + 31) / 32) : blocks_for(n);
  k_add<Fq, M1><<<blocks, kThreads, M1::smem_bytes(kThreads), static_cast<cudaStream_t>(stream)>>>(
      (u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy, (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

template <class M1, class M2>
int launch_double(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
                  void* oz, long long n, int times, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_double<Fq2, M2><<<blocks_for(n), kThreads, M2::smem_bytes(kThreads), s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, times);
  } else {
    k_double<Fq, M1><<<blocks_for(n), kThreads, M1::smem_bytes(kThreads), s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, times);
  }
  return (int)cudaGetLastError();
}

// points (npts, L) / (npts, 2, L), every code naming one of them; codes
// (steps, lanes) int32; out (lanes, ...) x3 and exc (lanes,) int32.
template <class M1, class M2>
int launch_madd_scan(int g2, const void* px, const void* py, const void* codes, int steps,
                     long long lanes, void* ox, void* oy, void* oz, void* exc, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_madd_scan<Fq2, M2><<<blocks_for(lanes), kThreads, kScanSmem<Fq2, M2>, s>>>(
        (u32p)px, (u32p)py, (const int32_t*)codes, steps, lanes, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, (int32_t*)exc);
  } else {
    k_madd_scan<Fq, M1><<<blocks_for(lanes), kThreads, kScanSmem<Fq, M1>, s>>>(
        (u32p)px, (u32p)py, (const int32_t*)codes, steps, lanes, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, (int32_t*)exc);
  }
  return (int)cudaGetLastError();
}

// coordinates (rows * bw, ...) in and out, 1 <= shift; out must not alias in.
template <class M1, class M2>
int launch_add_shift(int g2, const void* px, const void* py, const void* pz, void* ox, void* oy,
                     void* oz, long long n, int bw, int shift, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_add_shift<Fq2, M2><<<blocks_for(n), kThreads, M2::smem_bytes(kThreads), s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, bw, shift);
  } else {
    k_add_shift<Fq, M1><<<blocks_for(n), kThreads, M1::smem_bytes(kThreads), s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, bw, shift);
  }
  return (int)cudaGetLastError();
}

template <class M1, class M2>
int launch_add_distinct(int g2, const void* px, const void* py, const void* pz, const void* qx,
                        const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_add_distinct<Fq2, M2><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy, (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, n);
  } else {
    k_add_distinct<Fq, M1><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy, (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

// K5 (g2 = 0) / K6 (g2 = 1); exc: (n,) int32.
template <class M1, class M2>
int launch_addx(int g2, const void* px, const void* py, const void* pz, const void* qx,
                const void* qy, const void* qz, void* ox, void* oy, void* oz, void* exc,
                long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g2) {
    k_addx<Fq2, M2><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy, (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, (int32_t*)exc, n);
  } else {
    k_addx<Fq, M1><<<blocks_for(n), kThreads, 0, s>>>(
        (u32p)px, (u32p)py, (u32p)pz, (u32p)qx, (u32p)qy, (u32p)qz, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, (int32_t*)exc, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace
