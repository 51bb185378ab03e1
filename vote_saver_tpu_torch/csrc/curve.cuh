// Jacobian group law on y^2 = x^3 + b (a = 0), templated over the
// coordinate field: E = Fq for G1, E = Fq2 for G2.
//
// Replaces the formulas of vote_saver_tpu/ops/pallas_field.py that its
// kernels are built from: _jac_double (l.348-363), _jac_addx (l.366-403),
// _jac_add with complete=True and complete=False (l.406-441) and _jac_madd
// (l.818-866).  Every formula takes the multiplier mode M (mul_modes.cuh) as
// a template parameter; the kernels (curve_kernels.cuh) instantiate them in
// each of the three modes.
// One thread owns one lane; the results equal the Pallas formulas' select
// chains limb for limb:
//
//   add:    same (h = 0, r = 0, both finite) -> double(p);
//           opposite (h = 0, r != 0, both finite) -> infinity (1, 1, 0);
//           p infinite -> q;  q infinite (p finite) -> p.
//   add_distinct: p infinite -> q;  q infinite (p finite) -> p;  otherwise
//           the generic formula, h = 0 included (then z3 = 0).
//   addx:   add_distinct plus exc = 1 where h = 0, r = 0, both finite.
//   madd:   q = (0, 0) -> lane inactive;  y negated as 0 - y when sign;
//           acc infinite -> (x2, y2, 1);  h = 0, r != 0 -> infinity;
//           h = 0, r = 0 (the doubling corner) -> exc = 1, acc' = generic
//           result (the caller falls back to a complete-formula MSM).
//
// What bounds it: the field multiplies, i.e. integer multiply throughput.
// Per lane, in G1 (G2: a square is 2 Fq muls, a multiply 3): madd 11
// (4 squares + 7 multiplies), add, add_distinct and addx 16 (5 + 11), the
// complete add's doubling branch 8 + 7, double 7 (5 + 2).
// Design: where the Pallas kernel computes both branches and selects, these
// kernels branch on the per-lane predicate instead.  Each lane's output is
// the same value; the doubling in the complete add and the whole madd of an
// inactive lane are computed only where they are taken, which keeps the
// doubling's temporaries out of the generic path's register live range.
// jac_madd_select and jac_add_select are the madd and the complete add in
// the Pallas form, every multiply on every lane and the result selected,
// for a mode whose multiply a warp runs together (the tensor-core fold:
// mma.sync is .sync.aligned).
#pragma once

#include "mul_modes.cuh"

template <class E>
struct Jac {
  E x, y, z;
};

// A thread's Jacobian point kept in the block's shared memory instead of
// registers, word-major: word w at base[w * stride], base = the area's
// start + threadIdx.x and stride = the block's threads, so the 32 threads
// of a warp touch 32 consecutive words (no bank conflict).  jac_madd_select
// reads its coordinates where a formula step uses them (jx, jy, jz) and
// writes the result once (put); with the multiply called out of line the
// point is then not live across the calls, where it would be saved on the
// thread's stack (curve_kernels.cuh: the converged G2 scan's accumulator).
template <class E>
struct ParkedJac {
  uint32_t* base;
  int stride;
};

template <class P>
__device__ __forceinline__ void park_load(Fp<P>& x, const uint32_t* base, int stride, int w) {
#pragma unroll
  for (int j = 0; j < P::L; ++j) x.v[j] = base[(w + j) * stride];
}

__device__ __forceinline__ void park_load(Fq2& x, const uint32_t* base, int stride, int w) {
  park_load(x.c0, base, stride, w);
  park_load(x.c1, base, stride, w + FqParams::L);
}

template <class P>
__device__ __forceinline__ void park_store(uint32_t* base, int stride, int w, const Fp<P>& x) {
#pragma unroll
  for (int j = 0; j < P::L; ++j) base[(w + j) * stride] = x.v[j];
}

__device__ __forceinline__ void park_store(uint32_t* base, int stride, int w, const Fq2& x) {
  park_store(base, stride, w, x.c0);
  park_store(base, stride, w + FqParams::L, x.c1);
}

// The coordinates of an accumulator, in registers or parked.
template <class E>
__device__ __forceinline__ const E& jx(const Jac<E>& a) { return a.x; }
template <class E>
__device__ __forceinline__ const E& jy(const Jac<E>& a) { return a.y; }
template <class E>
__device__ __forceinline__ const E& jz(const Jac<E>& a) { return a.z; }
template <class E>
__device__ __forceinline__ void put(Jac<E>& a, const Jac<E>& v) { a = v; }

template <class E>
__device__ __forceinline__ E park_coord(const ParkedJac<E>& a, int c) {
  E v;
  park_load(v, a.base, a.stride, c * (int)(sizeof(E) / 4));
  return v;
}
template <class E>
__device__ __forceinline__ E jx(const ParkedJac<E>& a) { return park_coord(a, 0); }
template <class E>
__device__ __forceinline__ E jy(const ParkedJac<E>& a) { return park_coord(a, 1); }
template <class E>
__device__ __forceinline__ E jz(const ParkedJac<E>& a) { return park_coord(a, 2); }
template <class E>
__device__ __forceinline__ void put(ParkedJac<E>& a, const Jac<E>& v) {
  constexpr int w = (int)(sizeof(E) / 4);
  park_store(a.base, a.stride, 0, v.x);
  park_store(a.base, a.stride, w, v.y);
  park_store(a.base, a.stride, 2 * w, v.z);
}

template <class E, class M>
__device__ __forceinline__ Jac<E> jac_double(const Jac<E>& p) {
  const E a = fsq<M>(p.x);
  const E b = fsq<M>(p.y);
  const E c = fsq<M>(b);
  E d = sub(fsq<M>(add(p.x, b)), add(a, c));
  d = add(d, d);
  const E e = add(add(a, a), a);
  const E ff = fsq<M>(e);
  const E x3 = sub(ff, add(d, d));
  E c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  const E y3 = sub(fmul<M>(e, sub(d, x3)), c8);
  const E z3 = fmul<M>(add(p.y, p.y), p.z);
  return {x3, y3, z3};
}

// One round of jac_double_warps: warp w multiplies x * y for its 32 lanes
// (its operands are product w of the round), and every thread gets the
// round's 4 products of its lane, passed through each warp's tile.
template <class M>
__device__ __forceinline__ void warp_round(const Fq& x, const Fq& y, Fq (&t)[4]) {
  const Fq r = fq_mul_call<M>(x, y);
  const int lane = threadIdx.x & 31;
  reinterpret_cast<Fq*>(M::warp_tile(threadIdx.x >> 5))[lane] = r;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 4; ++w) t[w] = reinterpret_cast<const Fq*>(M::warp_tile(w))[lane];
  __syncthreads();  // the tiles are free for the next round's multiplies
}

__device__ __forceinline__ Fq pick(int w, const Fq& a, const Fq& b, const Fq& c, const Fq& d) {
  return sel(w == 0, a, sel(w == 1, b, sel(w == 2, c, d)));
}

// jac_double in G2 on the 4 warps of a block that all hold the same 32
// lanes, for a converged mode whose warps pass values through their tiles
// (MulFoldMma::warp_tile): the doubling's 16 Fq products (5 Fq2 squares of
// 2, 2 Fq2 multiplies of 3, the Karatsuba forms of fsq / fmul) in 4 rounds
// of 4, warp w taking product w of each round:
//   1. a = x^2, b = y^2                   a.t0  a.t1  b.t0  b.t1
//   2. c = b^2, s = (x + b)^2             c.t0  c.t1  s.t0  s.t1
//   3. ff = e^2 (e = 3a), z3 = 2y * z     ff.t0 ff.t1 z3.t0 z3.t1
//   4.                    y3 = e(d - x3)  z3.t2 m.t0  m.t1  m.t2
// A chain of 4 multiplies a doubling, against jac_double's 16.  Same limbs.
template <class M>
__device__ Jac<Fq2> jac_double_warps(const Jac<Fq2>& p) {
  const int w = threadIdx.x >> 5;
  const Fq2 &x = p.x, &y = p.y, &z = p.z;
  Fq t[4];
  warp_round<M>(pick(w, add(x.c0, x.c1), x.c0, add(y.c0, y.c1), y.c0),
                pick(w, sub(x.c0, x.c1), x.c1, sub(y.c0, y.c1), y.c1), t);
  const Fq2 a = {t[0], add(t[1], t[1])};
  const Fq2 b = {t[2], add(t[3], t[3])};
  const Fq2 u = add(x, b);
  warp_round<M>(pick(w, add(b.c0, b.c1), b.c0, add(u.c0, u.c1), u.c0),
                pick(w, sub(b.c0, b.c1), b.c1, sub(u.c0, u.c1), u.c1), t);
  const Fq2 c = {t[0], add(t[1], t[1])};
  Fq2 d = sub(Fq2{t[2], add(t[3], t[3])}, add(a, c));
  d = add(d, d);
  const Fq2 e = add(add(a, a), a);
  const Fq2 v = add(y, y);
  warp_round<M>(pick(w, add(e.c0, e.c1), e.c0, v.c0, v.c1), pick(w, sub(e.c0, e.c1), e.c1, z.c0, z.c1), t);
  const Fq2 ff = {t[0], add(t[1], t[1])};
  const Fq z0 = t[2], z1 = t[3];
  const Fq2 x3 = sub(ff, add(d, d));
  const Fq2 g = sub(d, x3);
  warp_round<M>(pick(w, add(v.c0, v.c1), e.c0, e.c1, add(e.c0, e.c1)),
                pick(w, add(z.c0, z.c1), g.c0, g.c1, add(g.c0, g.c1)), t);
  Fq2 c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  const Fq2 m = {sub(t[1], t[2]), sub(t[3], add(t[1], t[2]))};
  return {x3, sub(m, c8), {sub(z0, z1), sub(t[0], add(z0, z1))}};
}

template <class E>
__device__ __forceinline__ Jac<E> jac_infinity() {
  const E one = one_of<E>();
  return {one, one, zero_of<E>()};
}

// Complete Jacobian add.
template <class E, class M>
__device__ Jac<E> jac_add(const Jac<E>& p, const Jac<E>& q) {
  const bool p_inf = is_zero(p.z);
  const bool q_inf = is_zero(q.z);
  const E z1z1 = fsq<M>(p.z);
  const E z2z2 = fsq<M>(q.z);
  const E u1 = fmul<M>(p.x, z2z2);
  const E u2 = fmul<M>(q.x, z1z1);
  const E s1 = fmul<M>(fmul<M>(p.y, q.z), z2z2);
  const E s2 = fmul<M>(fmul<M>(q.y, p.z), z1z1);
  const E h = sub(u2, u1);
  E rr = sub(s2, s1);
  rr = add(rr, rr);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(rr);
  Jac<E> out;
  if (h_zero && r_zero && !p_inf && !q_inf) {
    out = jac_double<E, M>(p);
  } else if (h_zero && !r_zero && !p_inf && !q_inf) {
    out = jac_infinity<E>();
  } else {
    const E i = fsq<M>(add(h, h));
    const E j = fmul<M>(h, i);
    const E v = fmul<M>(u1, i);
    out.x = sub(sub(fsq<M>(rr), j), add(v, v));
    const E s1j = fmul<M>(s1, j);
    out.y = sub(fmul<M>(rr, sub(v, out.x)), add(s1j, s1j));
    out.z = fmul<M>(sub(fsq<M>(add(p.z, q.z)), add(z1z1, z2z2)), h);
  }
  if (p_inf) out = q;
  if (q_inf && !p_inf) out = p;
  return out;
}

// jac_add without a per-lane branch: the generic 16 multiplies on every
// lane, then the selects in the order of the Pallas _jac_add
// (vote_saver_tpu/ops/pallas_field.py:406-441) and of the plain
// hopper_field.jac_add: same -> double(p), opposite -> infinity, p infinite
// -> q, q infinite and p finite -> p.  Same limbs as jac_add.  Every thread
// of the warp calls it together (a converged mode's kernel): the doubling's
// 7 multiplies run only where some lane of the warp is a same lane, a
// warp-uniform test, so every thread reaches every multiply.
template <class E, class M>
__device__ Jac<E> jac_add_select(const Jac<E>& p, const Jac<E>& q) {
  const E z1z1 = fsq<M>(p.z);
  const E z2z2 = fsq<M>(q.z);
  const E u1 = fmul<M>(p.x, z2z2);
  const E u2 = fmul<M>(q.x, z1z1);
  const E s1 = fmul<M>(fmul<M>(p.y, q.z), z2z2);
  const E s2 = fmul<M>(fmul<M>(q.y, p.z), z1z1);
  const E h = sub(u2, u1);
  E rr = sub(s2, s1);
  rr = add(rr, rr);
  const E i = fsq<M>(add(h, h));
  const E j = fmul<M>(h, i);
  const E v = fmul<M>(u1, i);
  Jac<E> out;
  out.x = sub(sub(fsq<M>(rr), j), add(v, v));
  const E s1j = fmul<M>(s1, j);
  out.y = sub(fmul<M>(rr, sub(v, out.x)), add(s1j, s1j));
  out.z = fmul<M>(sub(fsq<M>(add(p.z, q.z)), add(z1z1, z2z2)), h);
  const bool p_inf = is_zero(p.z);
  const bool q_inf = is_zero(q.z);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(rr);
  const bool same = h_zero && r_zero && !p_inf && !q_inf;
  if (__any_sync(0xffffffffu, same)) {
    const Jac<E> d = jac_double<E, M>(p);
    out = {sel(same, d.x, out.x), sel(same, d.y, out.y), sel(same, d.z, out.z)};
  }
  const bool opposite = h_zero && !r_zero && !p_inf && !q_inf;
  const E one = one_of<E>();
  out = {sel(opposite, one, out.x), sel(opposite, one, out.y), sel(opposite, zero_of<E>(), out.z)};
  out = {sel(p_inf, q.x, out.x), sel(p_inf, q.y, out.y), sel(p_inf, q.z, out.z)};
  const bool keep = q_inf && !p_inf;
  return {sel(keep, p.x, out.x), sel(keep, p.y, out.y), sel(keep, p.z, out.z)};
}

// Distinct-operand Jacobian add (_jac_add with complete=False): the generic
// 16-multiply formula with only the two infinity selects.  Callers promise
// p != +-q whenever both are finite (window-decomposition sums).  Where that
// promise is broken, h = 0 and the result is the formula's own (x3, y3, 0),
// NOT canonical infinity: the Pallas kernel computes exactly that, so this
// one must not branch on h either.
template <class E, class M>
__device__ Jac<E> jac_add_distinct(const Jac<E>& p, const Jac<E>& q) {
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  const E z1z1 = fsq<M>(p.z);
  const E z2z2 = fsq<M>(q.z);
  const E u1 = fmul<M>(p.x, z2z2);
  const E u2 = fmul<M>(q.x, z1z1);
  const E s1 = fmul<M>(fmul<M>(p.y, q.z), z2z2);
  const E s2 = fmul<M>(fmul<M>(q.y, p.z), z1z1);
  const E h = sub(u2, u1);
  E rr = sub(s2, s1);
  rr = add(rr, rr);
  const E i = fsq<M>(add(h, h));
  const E j = fmul<M>(h, i);
  const E v = fmul<M>(u1, i);
  Jac<E> out;
  out.x = sub(sub(fsq<M>(rr), j), add(v, v));
  const E s1j = fmul<M>(s1, j);
  out.y = sub(fmul<M>(rr, sub(v, out.x)), add(s1j, s1j));
  out.z = fmul<M>(sub(fsq<M>(add(p.z, q.z)), add(z1z1, z2z2)), h);
  return out;
}

// Flagged distinct add (_jac_addx): the generic 16-multiply formula with the
// two infinity selects, plus a per-lane flag for the doubling corner (h = 0,
// r = 0, both finite), which it does not handle.  p = -q (h = 0, r != 0)
// falls out as z3 = 0; p = q gives the formula's own (x3, y3, 0) and sets
// `exc`, which the caller ORs into its fallback decision.
template <class E, class M>
__device__ Jac<E> jac_addx(const Jac<E>& p, const Jac<E>& q, uint32_t& exc) {
  exc = 0u;
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  const E z1z1 = fsq<M>(p.z);
  const E z2z2 = fsq<M>(q.z);
  const E u1 = fmul<M>(p.x, z2z2);
  const E u2 = fmul<M>(q.x, z1z1);
  const E s1 = fmul<M>(fmul<M>(p.y, q.z), z2z2);
  const E s2 = fmul<M>(fmul<M>(q.y, p.z), z1z1);
  const E h = sub(u2, u1);
  E rr = sub(s2, s1);
  rr = add(rr, rr);
  exc = (is_zero(h) && is_zero(rr)) ? 1u : 0u;
  const E i = fsq<M>(add(h, h));
  const E j = fmul<M>(h, i);
  const E v = fmul<M>(u1, i);
  Jac<E> out;
  out.x = sub(sub(fsq<M>(rr), j), add(v, v));
  const E s1j = fmul<M>(s1, j);
  out.y = sub(fmul<M>(rr, sub(v, out.x)), add(s1j, s1j));
  out.z = fmul<M>(sub(fsq<M>(add(p.z, q.z)), add(z1z1, z2z2)), h);
  return out;
}

// acc += (-1)^sign * (x2, y2) where active; returns the doubling-corner flag.
template <class E, class M>
__device__ uint32_t jac_madd(Jac<E>& acc, const E& x2, E y2, bool sign, bool active) {
  active = active && !(is_zero(x2) && is_zero(y2));
  if (!active) return 0u;
  if (sign) y2 = sub(zero_of<E>(), y2);
  const bool p_inf = is_zero(acc.z);
  if (p_inf) {
    acc = {x2, y2, one_of<E>()};
    return 0u;
  }
  const E z1z1 = fsq<M>(acc.z);
  const E u2 = fmul<M>(x2, z1z1);
  const E s2 = fmul<M>(fmul<M>(y2, acc.z), z1z1);
  const E h = sub(u2, acc.x);
  E r = sub(s2, acc.y);
  r = add(r, r);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(r);
  if (h_zero && !r_zero) {
    acc = jac_infinity<E>();
    return 0u;
  }
  const E hh = fsq<M>(h);
  E i = add(hh, hh);
  i = add(i, i);
  const E j = fmul<M>(h, i);
  const E v = fmul<M>(acc.x, i);
  const E x3 = sub(sub(fsq<M>(r), j), add(v, v));
  const E y1j = fmul<M>(acc.y, j);
  const E y3 = sub(fmul<M>(r, sub(v, x3)), add(y1j, y1j));
  const E z3 = sub(sub(fsq<M>(add(acc.z, h)), z1z1), hh);
  acc = {x3, y3, z3};
  return (h_zero && r_zero) ? 1u : 0u;
}

// jac_madd without a data-dependent branch: all 11 multiplies on every lane,
// then the selects in the order of the Pallas _jac_madd
// (vote_saver_tpu/ops/pallas_field.py:818-866) and of the plain
// hopper_field.jac_madd: the lift where acc is infinite, infinity where
// h = 0, r != 0 and acc is finite, acc kept where the lane is inactive; the
// flag where h = 0, r = 0, acc finite and the lane active.  Same limbs and
// flag as jac_madd.  acc is a Jac<E> or a ParkedJac<E>.
template <class E, class M, class A>
__device__ uint32_t jac_madd_select(A& acc, const E& x2, E y2, bool sign, bool active) {
  active = active && !(is_zero(x2) && is_zero(y2));
  y2 = sel(sign, sub(zero_of<E>(), y2), y2);
  const E z1z1 = fsq<M>(jz(acc));
  const E u2 = fmul<M>(x2, z1z1);
  const E s2 = fmul<M>(fmul<M>(y2, jz(acc)), z1z1);
  const E h = sub(u2, jx(acc));
  const E hh = fsq<M>(h);
  E i = add(hh, hh);
  i = add(i, i);
  const E j = fmul<M>(h, i);
  E r = sub(s2, jy(acc));
  r = add(r, r);
  const E v = fmul<M>(jx(acc), i);
  const E x3 = sub(sub(fsq<M>(r), j), add(v, v));
  const E y1j = fmul<M>(jy(acc), j);
  const E y3 = sub(fmul<M>(r, sub(v, x3)), add(y1j, y1j));
  const E z3 = sub(sub(fsq<M>(add(jz(acc), h)), z1z1), hh);
  const bool p_inf = is_zero(jz(acc));
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(r);
  const E one = one_of<E>();
  Jac<E> out = {sel(p_inf, x2, x3), sel(p_inf, y2, y3), sel(p_inf, one, z3)};
  const bool opposite = h_zero && !r_zero && !p_inf;
  out = {sel(opposite, one, out.x), sel(opposite, one, out.y), sel(opposite, zero_of<E>(), out.z)};
  put(acc, {sel(active, out.x, jx(acc)), sel(active, out.y, jy(acc)), sel(active, out.z, jz(acc))});
  return (h_zero && r_zero && !p_inf && active) ? 1u : 0u;
}
