// Jacobian group law on y^2 = x^3 + b (a = 0), templated over the
// coordinate field: E = Fq for G1, E = Fq2 for G2.
//
// Replaces the formulas of vote_saver_tpu/ops/pallas_field.py that its
// kernels are built from: _jac_double (l.348-363), _jac_add with
// complete=True (l.406-441) and _jac_madd (l.818-866).  One thread owns one
// lane; the results equal the Pallas formulas' select chains limb for limb:
//
//   add:    same (h = 0, r = 0, both finite) -> double(p);
//           opposite (h = 0, r != 0, both finite) -> infinity (1, 1, 0);
//           p infinite -> q;  q infinite (p finite) -> p.
//   madd:   q = (0, 0) -> lane inactive;  y negated as 0 - y when sign;
//           acc infinite -> (x2, y2, 1);  h = 0, r != 0 -> infinity;
//           h = 0, r = 0 (the doubling corner) -> exc = 1, acc' = generic
//           result (the caller falls back to a complete-formula MSM).
//
// What bounds it: the field multiplies (madd 11 Fq muls, add 16 + the
// 9-mul double, double 9; x3 in Fq2), i.e. integer multiply throughput.
// Design: where the Pallas kernel computes both branches and selects, these
// kernels branch on the per-lane predicate instead.  Each lane's output is
// the same value; the doubling in the complete add and the whole madd of an
// inactive lane are computed only where they are taken, which keeps the
// doubling's temporaries out of the generic path's register live range.
#pragma once

#include "field.cuh"

template <class E>
struct Jac {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Jac<E> jac_double(const Jac<E>& p) {
  const E a = sq(p.x);
  const E b = sq(p.y);
  const E c = sq(b);
  E d = sub(sq(add(p.x, b)), add(a, c));
  d = add(d, d);
  const E e = add(add(a, a), a);
  const E ff = sq(e);
  const E x3 = sub(ff, add(d, d));
  E c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  const E y3 = sub(mul(e, sub(d, x3)), c8);
  const E z3 = mul(add(p.y, p.y), p.z);
  return {x3, y3, z3};
}

template <class E>
__device__ __forceinline__ Jac<E> jac_infinity() {
  const E one = one_of<E>();
  return {one, one, zero_of<E>()};
}

// Complete Jacobian add.
template <class E>
__device__ Jac<E> jac_add(const Jac<E>& p, const Jac<E>& q) {
  const bool p_inf = is_zero(p.z);
  const bool q_inf = is_zero(q.z);
  const E z1z1 = sq(p.z);
  const E z2z2 = sq(q.z);
  const E u1 = mul(p.x, z2z2);
  const E u2 = mul(q.x, z1z1);
  const E s1 = mul(mul(p.y, q.z), z2z2);
  const E s2 = mul(mul(q.y, p.z), z1z1);
  const E h = sub(u2, u1);
  E rr = sub(s2, s1);
  rr = add(rr, rr);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(rr);
  Jac<E> out;
  if (h_zero && r_zero && !p_inf && !q_inf) {
    out = jac_double(p);
  } else if (h_zero && !r_zero && !p_inf && !q_inf) {
    out = jac_infinity<E>();
  } else {
    const E i = sq(add(h, h));
    const E j = mul(h, i);
    const E v = mul(u1, i);
    out.x = sub(sub(sq(rr), j), add(v, v));
    const E s1j = mul(s1, j);
    out.y = sub(mul(rr, sub(v, out.x)), add(s1j, s1j));
    out.z = mul(sub(sq(add(p.z, q.z)), add(z1z1, z2z2)), h);
  }
  if (p_inf) out = q;
  if (q_inf && !p_inf) out = p;
  return out;
}

// acc += (-1)^sign * (x2, y2) where active; returns the doubling-corner flag.
template <class E>
__device__ uint32_t jac_madd(Jac<E>& acc, const E& x2, E y2, bool sign, bool active) {
  active = active && !(is_zero(x2) && is_zero(y2));
  if (!active) return 0u;
  if (sign) y2 = sub(zero_of<E>(), y2);
  const bool p_inf = is_zero(acc.z);
  if (p_inf) {
    acc = {x2, y2, one_of<E>()};
    return 0u;
  }
  const E z1z1 = sq(acc.z);
  const E u2 = mul(x2, z1z1);
  const E s2 = mul(mul(y2, acc.z), z1z1);
  const E h = sub(u2, acc.x);
  E r = sub(s2, acc.y);
  r = add(r, r);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(r);
  if (h_zero && !r_zero) {
    acc = jac_infinity<E>();
    return 0u;
  }
  const E hh = sq(h);
  E i = add(hh, hh);
  i = add(i, i);
  const E j = mul(h, i);
  const E v = mul(acc.x, i);
  const E x3 = sub(sub(sq(r), j), add(v, v));
  const E y1j = mul(acc.y, j);
  const E y3 = sub(mul(r, sub(v, x3)), add(y1j, y1j));
  const E z3 = sub(sub(sq(add(acc.z, h)), z1z1), hh);
  acc = {x3, y3, z3};
  return (h_zero && r_zero) ? 1u : 0u;
}
