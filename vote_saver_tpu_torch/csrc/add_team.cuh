// K3 in G2, the complete Jacobian add, as a team of 16 threads a lane.
//
// Replaces: vote_saver_tpu/ops/pallas_field.py _g2_add_call(complete=True)
// (l.554; pallas_call l.570), which computes _jac_add(emit, p, q,
// complete=True) (l.406-441) on (2, 12, S, T) tiles, one vreg lane a point.
// Wrapper: ops/hopper_field.g2_add (every mode).  It replaces a one-thread-a-lane
// k_add<Fq2>, which ran slower at every width the vote path launches and at
// 2^14 lanes (PERF.md, Findings).
//
// What bounds it where the vote path runs it: latency.  The path adds 16 to
// a few hundred lanes a launch (the ballot tail's windowed G2 multiply at
// 32, the b2 MSM's Horner steps at 16, its orphan merges at their live
// widths).  One thread a lane fills less than a warp there, and its time is
// one lane's chain of 43 dependent Fq multiplies at 255 registers with
// spills.  Here a lane's add runs in the dependency levels of its DAG
// (ops/add_team.py): 12, 12, 7, 6 and 6 independent Fq products, one a
// thread, so 5 multiplies lie on the critical path.
//
// Design:
//   * Two teams a warp, one warp a block: 16 lanes occupy 8 SMs, 32 lanes
//     16.  16 threads is the smallest power of two that holds the widest
//     level (12 products) in one round, so a level costs one Fq multiply,
//     and a team is a half warp, whose threads step together.
//   * The team executes the table of add_team_g2.cuh, generated from
//     ops/add_team.schedule(g2=True) and held equal to it by the CPU tests:
//     phases of up to 16 Fq products (the mode's multiply: in loop K1's
//     CIOS body, field.cuh mul) or of
//     up to 16 Fq adds/subtracts, thread r taking op r.  Every Fq value
//     lives in a slot of the team's shared memory (39 slots); a phase reads
//     its operands from slots and writes slots that no operand of the phase
//     occupies, so a __syncwarp over the team's half of the warp between
//     phases is the only synchronisation.  A thread holds two operands, its
//     result and the CIOS temporaries, which keeps it far from spilling.
//   * A slot is 48 bytes, read and written as three 16-byte words: 8
//     threads reading slots that differ mod 8 touch 8 disjoint groups of 4
//     banks.  The lane's coordinates move as 16-byte words too.
//   * A linear phase's adds and subtracts run one branch-free body
//     (add_or_sub).  The block copies the whole table (3.2 KB) into shared
//     memory at its start, its loads issued with the lane's.
//   * The team takes one branch a lane, so the selects of curve.cuh's
//     jac_add hold limb for limb: p infinite -> q and q infinite -> p (no
//     phase runs); otherwise the pre section (levels 1-2, h and rr), then
//     h = 0 and rr = 0 -> the doubling of p (3 levels: 7, 6, 3 products),
//     h = 0 alone -> canonical infinity (1, 1, 0), else the rest of the
//     generic formula (levels 3-5).
//   * A team past n leaves at once: it computes and stores nothing.
// The kernel is written over the schedule type T (the coordinate field's
// width T::kComps); only G2's is built.
//
// The kernel takes the multiplier mode M (mul_modes.cuh) of its Fq
// products, as every curve kernel does: the table is the same in every
// mode.  add_team.cu instantiates it in loop (K1's CIOS body inlined),
// curve_v1.cu in v1 and curve_fold.cu in fold, there over MulFoldMma
// (fold_mma.cuh): each multiply's fold product a warp's tile on the int8
// tensor cores.
//
// The converged form, for such a mode (M::kConverged: mma.sync is
// .sync.aligned, so all 32 threads of a warp reach every multiply).  A
// multiply phase of a warp is 32 threads with 32 operand pairs, one A tile,
// so the team's layout stands; what changes is who multiplies and who
// writes:
//   * Blocks of 8 teams (4 warps, 128 threads), so that one copy of the B
//     operand (M::prologue, the dynamic shared memory M::smem_bytes(128):
//     55,936 B) serves 8 lanes; the slots and the table add 18,192 B of
//     static shared memory.  The prologue's block barrier also publishes
//     the table.
//   * After the prologue, a warp whose two lanes are both past n leaves; a
//     team past n in a live warp computes on lane n - 1 and stores nothing.
//   * The warp runs a section (pre, gen, dbl) where either of its teams
//     takes it (__any_sync), in that order.  A team writes slots only in
//     the section its own outcome takes: dbl reuses slots of pre and gen,
//     and pre may free q's input slots, which the q outcome reads.
//   * In a multiply phase every thread multiplies; an idle thread (no op,
//     or its team not in the section) multiplies the zero slot by itself
//     and drops the product.  A linear phase runs on the writing threads
//     alone.  The syncs between phases are whole-warp.
// Critical path: 5 chained tile multiplies for a generic add, 3 more in a
// warp where a team needs the doubling.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "add_team_g2.cuh"
#include "field.cuh"
#include "mul_modes.cuh"

namespace {

constexpr int kTeam = 16;
constexpr int kTeamsPerBlock = 2;
// teams a block of the converged form: 4 warps, one copy of the B operand
constexpr int kTeamsConverged = 8;
constexpr int kL = FqParams::L;
constexpr int kV = kL / 4;  // uint4 a slot

template <class M>
constexpr int kTeamsOf = M::kConverged ? kTeamsConverged : kTeamsPerBlock;

__device__ __forceinline__ bool slot_zero(const uint4* s, int slot) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const uint4 w = s[slot * kV + j];
    acc |= w.x | w.y | w.z | w.w;
  }
  return acc == 0;
}

// Every slot of `slots` (a function of k < T::kComps) holds zero.
template <class T, class F>
__device__ __forceinline__ bool all_zero(const uint4* s, F slots) {
  bool z = true;
#pragma unroll
  for (int k = 0; k < T::kComps; ++k) z = z && slot_zero(s, slots(k));
  return z;
}

__device__ __forceinline__ Fq load_slot(const uint4* s, int slot) {
  Fq x;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const uint4 w = s[slot * kV + j];
    x.v[4 * j] = w.x, x.v[4 * j + 1] = w.y, x.v[4 * j + 2] = w.z, x.v[4 * j + 3] = w.w;
  }
  return x;
}

// a + b or, where `minus`, a - b: field.cuh's add and sub as one branch-free
// body, so the adds and subtracts of a linear phase do not diverge.  With
// b' = b ^ m (m all ones where minus), two independent carry chains run side
// by side: t = a + b' + minus (a + b, or a - b mod 2^384) and u = a + b' + K
// + 1 with K = ~N for an add (u = a + b - N) and K = N for a subtract (u =
// a - b + N).  An add keeps u where it reached 2^384 (a + b >= N), a
// subtract where t borrowed (a < b).
__device__ __forceinline__ Fq add_or_sub(const Fq& a, const Fq& b, bool minus) {
  const uint32_t m = minus ? 0xffffffffu : 0u;
  uint32_t t[kL], u[kL];
  uint32_t ct = minus ? 1u : 0u;
  uint32_t cu = 1u;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const uint32_t bj = b.v[j] ^ m;
    const uint64_t x = (uint64_t)a.v[j] + bj + ct;
    const uint64_t y = (uint64_t)a.v[j] + bj + (FqParams::n(j) ^ ~m) + cu;
    t[j] = (uint32_t)x;
    ct = (uint32_t)(x >> 32);
    u[j] = (uint32_t)y;
    cu = (uint32_t)(y >> 32);
  }
  const bool pick = minus ? ct == 0u : cu != 0u;
  Fq r;
#pragma unroll
  for (int j = 0; j < kL; ++j) r.v[j] = pick ? u[j] : t[j];
  return r;
}

__device__ __forceinline__ void store_slot(uint4* s, uint32_t slot, const Fq& z) {
  uint4* d = s + slot * kV;
#pragma unroll
  for (int j = 0; j < kV; ++j) d[j] = make_uint4(z.v[4 * j], z.v[4 * j + 1], z.v[4 * j + 2], z.v[4 * j + 3]);
}

// One round trip for the lane's inputs and the whole table (a block of TPB
// threads copies it to tab4): every load is issued before the first store
// to shared memory (a block's misses, one after another, cost more than the
// adds they feed).  p then q, coordinate c's component k in slot c * C + k;
// a team whose lane is not live loads and stores none of it.
template <class T, int TPB>
__device__ __forceinline__ void team_fill(const uint4* const (&in)[6], long long lane, bool live, int rank,
                                          uint4* s, uint4* tab4) {
  constexpr int CV = T::kComps * kV;  // uint4 of one coordinate
  constexpr int PASSES = (CV + kTeam - 1) / kTeam;
  constexpr int TABV = T::kWords / 4;
  constexpr int TPASSES = (TABV + TPB - 1) / TPB;
  uint4 v_in[6][PASSES], v_tab[TPASSES];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int w = rank + j * kTeam;
      if (live && w < CV) v_in[c][j] = __ldg(in[c] + lane * CV + w);
    }
  }
#pragma unroll
  for (int j = 0; j < TPASSES; ++j) {
    const int w = threadIdx.x + j * TPB;
    if (w < TABV) v_tab[j] = __ldg(reinterpret_cast<const uint4*>(T::table()) + w);
  }
#pragma unroll
  for (int j = 0; j < TPASSES; ++j) {
    const int w = threadIdx.x + j * TPB;
    if (w < TABV) tab4[w] = v_tab[j];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int w = rank + j * kTeam;
      if (live && w < CV) s[c * CV + w] = v_in[c][j];
    }
  }
}

// Montgomery one and zero into their slots.
template <class T>
__device__ __forceinline__ void team_constants(uint4* s, int rank) {
  if (rank < kV) {
    s[T::kOne * kV + rank] = make_uint4(FqParams::one(4 * rank), FqParams::one(4 * rank + 1),
                                        FqParams::one(4 * rank + 2), FqParams::one(4 * rank + 3));
    s[T::kZero * kV + rank] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The result slots of `outcome` to lane `lane` of the outputs.
template <class T>
__device__ __forceinline__ void team_store(uint4* const (&out)[3], long long lane, int rank, const uint4* s,
                                           const uint32_t* tab, int outcome) {
  constexpr int C = T::kComps;
  constexpr int CV = C * kV;
  constexpr int PASSES = (CV + kTeam - 1) / kTeam;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int w = rank + j * kTeam;
      if (w < CV) out[c][lane * CV + w] = s[tab[T::kOutBase + 3 * C * outcome + c * C + w / kV] * kV + w % kV];
    }
  }
}

// The converged form (above): a team a lane, 8 teams a block, every thread
// of a live warp at each multiply.
template <class T, class M>
__device__ __forceinline__ void add_team_converged(const uint4* const (&in)[6], uint4* const (&out)[3],
                                                   long long n) {
  constexpr int C = T::kComps;
  __shared__ uint4 smem[kTeamsConverged][T::kSlots * kV];
  __shared__ uint4 tab4[T::kWords / 4];
  const int rank = threadIdx.x % kTeam;
  const int team = threadIdx.x / kTeam;
  const long long t = (long long)blockIdx.x * kTeamsConverged + team;
  uint4* s = smem[team];
  team_fill<T, kTeam * kTeamsConverged>(in, t < n ? t : n - 1, true, rank, s, tab4);
  team_constants<T>(s, rank);
  M::prologue();  // the B operand, then a block barrier: the slots and the table are in place
  if (t - (team & 1) >= n) return;  // both lanes of the warp are past n
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(tab4);

  const bool p_inf = all_zero<T>(s, [](int k) { return 2 * C + k; });
  const bool q_inf = all_zero<T>(s, [](int k) { return 5 * C + k; });
  int outcome = p_inf ? T::kOutQ : q_inf ? T::kOutP : -1;
  // sections 0 pre, 1 gen, 2 dbl, each where a team of the warp takes it
#pragma unroll 1
  for (int sec = 0; sec < 3; ++sec) {
    const bool mine = sec == 0 ? outcome < 0 : outcome == (sec == 1 ? T::kOutGen : T::kOutDbl);
    if (__any_sync(0xffffffffu, mine)) {
      const int begin = sec == 0 ? T::kPreBegin : sec == 1 ? T::kGenBegin : T::kDblBegin;
      const int end = sec == 0 ? T::kPreEnd : sec == 1 ? T::kGenEnd : T::kDblEnd;
#pragma unroll 1
      for (int ph = begin; ph < end; ++ph) {
        const uint32_t op = tab[ph * kTeam + rank];
        const bool act = mine && op != 0xffffffffu;
        if ((tab[ph * kTeam] >> 24) == 0u) {  // a multiply phase (op 0 is never idle): the whole warp
          const Fq x = load_slot(s, act ? (int)((op >> 8) & 0xffu) : T::kZero);
          const Fq y = load_slot(s, act ? (int)(op & 0xffu) : T::kZero);
          const Fq z = M::mul(x, y);
          if (act) store_slot(s, (op >> 16) & 0xffu, z);
        } else if (act) {
          const Fq z = add_or_sub(load_slot(s, (op >> 8) & 0xffu), load_slot(s, op & 0xffu), (op >> 24) == 2u);
          store_slot(s, (op >> 16) & 0xffu, z);
        }
        __syncwarp();
      }
    }
    if (sec == 0 && outcome < 0) {
      const bool h0 = all_zero<T>(s, [tab](int k) { return (int)tab[T::kHBase + k]; });
      const bool r0 = all_zero<T>(s, [tab](int k) { return (int)tab[T::kRBase + k]; });
      outcome = h0 && r0 ? T::kOutDbl : h0 ? T::kOutInf : T::kOutGen;
    }
  }
  if (t < n) team_store<T>(out, t, rank, s, tab, outcome);
}

template <class T, class M>
__global__ void __launch_bounds__(kTeam * kTeamsOf<M>)
    k_add_team(const uint4* __restrict__ px, const uint4* __restrict__ py,
               const uint4* __restrict__ pz, const uint4* __restrict__ qx,
               const uint4* __restrict__ qy, const uint4* __restrict__ qz,
               uint4* __restrict__ ox, uint4* __restrict__ oy, uint4* __restrict__ oz,
               long long n) {
  const uint4* const in[6] = {px, py, pz, qx, qy, qz};
  uint4* const out[3] = {ox, oy, oz};
  if constexpr (M::kConverged) {
    add_team_converged<T, M>(in, out, n);
  } else {
    constexpr int C = T::kComps;
    __shared__ uint4 smem[kTeamsPerBlock][T::kSlots * kV];
    __shared__ uint4 tab4[T::kWords / 4];
    const int rank = threadIdx.x % kTeam;
    const int team = threadIdx.x / kTeam;
    const long long lane = (long long)blockIdx.x * kTeamsPerBlock + team;
    const bool live = lane < n;
    uint4* s = smem[team];
    team_fill<T, kTeam * kTeamsPerBlock>(in, lane, live, rank, s, tab4);
    __syncwarp();
    const uint32_t* tab = reinterpret_cast<const uint32_t*>(tab4);
    if (!live) return;
    const unsigned mask = 0xFFFFu << (kTeam * team);
    team_constants<T>(s, rank);
    __syncwarp(mask);

    const bool p_inf = all_zero<T>(s, [](int k) { return 2 * C + k; });
    const bool q_inf = all_zero<T>(s, [](int k) { return 5 * C + k; });
    int outcome = p_inf ? T::kOutQ : q_inf ? T::kOutP : -1;
    int ph = T::kPreBegin;
    int end = outcome < 0 ? T::kPreEnd : ph;
    for (;;) {
      // thread `rank` runs op `rank` of each phase: all of one kind a phase
#pragma unroll 1
      for (; ph < end; ++ph) {
        const uint32_t op = tab[ph * kTeam + rank];
        if (op != 0xffffffffu) {
          const Fq x = load_slot(s, (op >> 8) & 0xffu);
          const Fq y = load_slot(s, op & 0xffu);
          const uint32_t kind = op >> 24;
          const Fq z = kind == 0u ? M::mul(x, y) : add_or_sub(x, y, kind == 2u);
          store_slot(s, (op >> 16) & 0xffu, z);
        }
        __syncwarp(mask);
      }
      if (outcome >= 0) break;
      const bool h0 = all_zero<T>(s, [tab](int k) { return (int)tab[T::kHBase + k]; });
      const bool r0 = all_zero<T>(s, [tab](int k) { return (int)tab[T::kRBase + k]; });
      if (h0 && r0) {
        outcome = T::kOutDbl;
        ph = T::kDblBegin;
        end = T::kDblEnd;
      } else if (h0) {
        outcome = T::kOutInf;
      } else {
        outcome = T::kOutGen;
        ph = T::kGenBegin;
        end = T::kGenEnd;
      }
    }
    team_store<T>(out, lane, rank, s, tab, outcome);
  }
}

// coordinates (n, 2, 12) each, int32 limbs read as uint4, 16-byte aligned;
// the outputs must not alias the inputs.  Runs on the caller's stream,
// does not synchronise, allocates nothing and returns cudaGetLastError() (0
// on success).  A converged mode's launch takes M::smem_bytes of dynamic
// shared memory, above 48 KB only once the card's limit is lifted (the fold
// unit's B operand upload does it, curve_fold.cu).
template <class M>
int launch_g2_add_team(const void* px, const void* py, const void* pz, const void* qx,
                       const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                       void* stream) {
  using v4p = const uint4*;
  constexpr int teams = kTeamsOf<M>;
  const unsigned blocks = (unsigned)((n + teams - 1) / teams);
  k_add_team<AddTeamG2, M><<<blocks, kTeam * teams, M::smem_bytes(kTeam * teams),
                             static_cast<cudaStream_t>(stream)>>>(
      (v4p)px, (v4p)py, (v4p)pz, (v4p)qx, (v4p)qy, (v4p)qz, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
  return (int)cudaGetLastError();
}

}  // namespace
