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
// jac_madd_select is the madd in the Pallas form, every multiply on every
// lane and the result selected, for a mode whose multiply a warp runs
// together (the tensor-core fold: mma.sync is .sync.aligned).
#pragma once

#include "mul_modes.cuh"

template <class E>
struct Jac {
  E x, y, z;
};

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
// flag as jac_madd.
template <class E, class M>
__device__ uint32_t jac_madd_select(Jac<E>& acc, const E& x2, E y2, bool sign, bool active) {
  active = active && !(is_zero(x2) && is_zero(y2));
  y2 = sel(sign, sub(zero_of<E>(), y2), y2);
  const E z1z1 = fsq<M>(acc.z);
  const E u2 = fmul<M>(x2, z1z1);
  const E s2 = fmul<M>(fmul<M>(y2, acc.z), z1z1);
  const E h = sub(u2, acc.x);
  const E hh = fsq<M>(h);
  E i = add(hh, hh);
  i = add(i, i);
  const E j = fmul<M>(h, i);
  E r = sub(s2, acc.y);
  r = add(r, r);
  const E v = fmul<M>(acc.x, i);
  const E x3 = sub(sub(fsq<M>(r), j), add(v, v));
  const E y1j = fmul<M>(acc.y, j);
  const E y3 = sub(fmul<M>(r, sub(v, x3)), add(y1j, y1j));
  const E z3 = sub(sub(fsq<M>(add(acc.z, h)), z1z1), hh);
  const bool p_inf = is_zero(acc.z);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(r);
  const E one = one_of<E>();
  Jac<E> out = {sel(p_inf, x2, x3), sel(p_inf, y2, y3), sel(p_inf, one, z3)};
  const bool opposite = h_zero && !r_zero && !p_inf;
  out = {sel(opposite, one, out.x), sel(opposite, one, out.y), sel(opposite, zero_of<E>(), out.z)};
  acc = {sel(active, out.x, acc.x), sel(active, out.y, acc.y), sel(active, out.z, acc.z)};
  return (h_zero && r_zero && !p_inf && active) ? 1u : 0u;
}
