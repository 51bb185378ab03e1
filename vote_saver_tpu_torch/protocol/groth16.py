"""Groth16 over BLS12-381: host setup, device prover from a host witness,
host verify.

Counterpart of ``vote_saver_tpu/protocol/groth16.py`` along the path the
vote phase takes with a host witness:

  * setup: QAP evaluation at tau and the CRS by native host fixed-base
    multiplication (the JAX package's host arm; identical CRS for the same
    ``FrRandom``);
  * prove: witness -> A/B/C by a COO matvec on the device (K1 multiplies,
    ``index_add_`` of int64 lazy limb columns, one ``reduce_lazy`` per row),
    the R1CS check, 3 iNTT + 3 coset NTT + 1 coset iNTT for H, then five
    scheduled MSMs (a/b1/l/h in G1, b2 in G2) with the B voters batched as
    parts, the var-base fallback on a flagged doubling corner, and the host
    blinding/assembly;
  * verify: the 4-term pairing check on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vote_saver_tpu.circuit.r1cs import ConstraintSystem
from vote_saver_tpu.params import FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu.refimpl import pairing as rp
from vote_saver_tpu.utils.rng import FrRandom

from ..ops import curve_ops as co
from ..ops import limbs as lb
from ..ops import msm as msm_mod
from ..ops import msm_sched as ms
from ..ops.field_ops import fr_ops
from ..ops.ntt import get_ntt


@dataclasses.dataclass
class ProvingKey:
    num_primary: int
    num_vars: int  # including ONE
    domain: int
    a_pts: list  # host affine int points, (num_vars,)
    b1_pts: list
    b2_pts: list  # G2
    h_pts: list  # (domain - 1,)
    l_pts: list  # (num_vars - num_primary - 1,)
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    coo: dict  # per matrix (rows, cols, coeffs) from ConstraintSystem.to_coo
    num_constraints: int
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)


@dataclasses.dataclass
class VerificationKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list  # host affine ints, num_primary + 1 (index 0 = ONE wire)


@dataclasses.dataclass
class Proof:
    a: tuple  # G1 affine ints
    b: tuple  # G2 affine ints
    c: tuple  # G1 affine ints


class StageTimer:
    """Per-stage wall seconds and event counts (``fallbacks``); synchronises
    the device at each mark so a stage's time includes its device work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now


# ---------------------------------------------------------------------------
# Setup (host-native arm)
# ---------------------------------------------------------------------------


def _batch_inv_host(xs: list[int]) -> list[int]:
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * xs[i] % R
    return out


def qap_evaluate(cs: ConstraintSystem, tau: int):
    """u_i(tau), v_i(tau), w_i(tau) for every wire, plus Z(tau) and domain."""
    nc, ni, m = cs.num_constraints, cs.num_primary, cs.num_vars
    domain = 1
    while domain < nc + ni + 1:
        domain *= 2
    omega = pow(FR_ROOT_OF_UNITY, (1 << FR_TWO_ADICITY) // domain, R)
    z_tau = (pow(tau, domain, R) - 1) % R
    omega_pows = [1] * domain
    for k in range(1, domain):
        omega_pows[k] = omega_pows[k - 1] * omega % R
    denom_inv = _batch_inv_host([(tau - omega_pows[k]) % R for k in range(domain)])
    n_inv = pow(domain, R - 2, R)
    lag = [z_tau * omega_pows[k] % R * n_inv % R * denom_inv[k] % R for k in range(domain)]
    u, v, w = [0] * m, [0] * m, [0] * m
    for k, (a, b, c) in enumerate(cs.constraints):
        for var, coeff in a.items():
            u[var] = (u[var] + coeff * lag[k]) % R
        for var, coeff in b.items():
            v[var] = (v[var] + coeff * lag[k]) % R
        for var, coeff in c.items():
            w[var] = (w[var] + coeff * lag[k]) % R
    # input consistency: A-poly of public wire i (incl. ONE) += L_{nc+i}
    for i in range(ni + 1):
        u[i] = (u[i] + lag[nc + i]) % R
    return u, v, w, z_tau, domain


def setup(cs: ConstraintSystem, rng: FrRandom) -> tuple[ProvingKey, VerificationKey]:
    nc, ni, m = cs.num_constraints, cs.num_primary, cs.num_vars
    tau, alpha, beta, gamma, delta = (rng() for _ in range(5))
    u, v, w, z_tau, domain = qap_evaluate(cs, tau)
    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)
    ic_exp = [(beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R for i in range(ni + 1)]
    l_exp = [(beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R for i in range(ni + 1, m)]
    h_exp, t_pow = [], 1
    for _ in range(domain - 1):
        h_exp.append(t_pow * z_tau % R * delta_inv % R)
        t_pow = t_pow * tau % R
    g1_points = rj.FixedBaseHost(rc.g1_gen, "g1").mul_many(u + v + h_exp + l_exp + ic_exp + [alpha, beta, delta])
    ofs = 0

    def take(k):
        nonlocal ofs
        out = g1_points[ofs : ofs + k]
        ofs += k
        return out

    a_pts, b1_pts, h_pts = take(m), take(m), take(domain - 1)
    l_pts, ic_pts = take(m - ni - 1), take(ni + 1)
    alpha_g1, beta_g1, delta_g1 = take(3)
    g2_points = rj.FixedBaseHost(rc.g2_gen, "g2").mul_many(v + [beta, gamma, delta])
    beta_g2, gamma_g2, delta_g2 = g2_points[m : m + 3]
    pk = ProvingKey(
        num_primary=ni, num_vars=m, domain=domain,
        a_pts=a_pts, b1_pts=b1_pts, b2_pts=g2_points[:m], h_pts=h_pts, l_pts=l_pts,
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        delta_g1=delta_g1, delta_g2=delta_g2,
        coo=cs.to_coo(), num_constraints=nc,
    )
    vk = VerificationKey(alpha_g1=alpha_g1, beta_g2=beta_g2, gamma_g2=gamma_g2,
                         delta_g2=delta_g2, ic=ic_pts)
    return pk, vk


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------


def _cache(pk: ProvingKey, key, build):
    if key not in pk._dev:
        pk._dev[key] = build()
    return pk._dev[key]


def _abc_coo_device(pk: ProvingKey, device):
    """Per-matrix COO tensors for the device A/B/C evaluation, cached on pk.

    Coefficients are in double-Montgomery form (c R^2 mod N): one Montgomery
    multiply with the Montgomery witness gives (c w)_mont * R, so the per-row
    lazy sum reduces straight to Montgomery form with one reduce_lazy.  The
    A matrix gains the input-consistency entries (row nc+i, col i, coeff 1)."""

    def build():
        spec = lb.FR
        out = {}
        for name in ("a", "b", "c"):
            rows, cols, coeffs = pk.coo[name]
            rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
            coeffs = list(coeffs)
            if name == "a":
                extra = pk.num_primary + 1
                rows = np.concatenate([rows, pk.num_constraints + np.arange(extra)])
                cols = np.concatenate([cols, np.arange(extra)])
                coeffs = coeffs + [1] * extra
            c2m = lb.ints_to_limbs([spec.to_mont(spec.to_mont(int(c))) for c in coeffs], spec)
            out[name] = (
                torch.from_numpy(rows).to(device),
                torch.from_numpy(cols).to(device),
                lb.to_tensor(c2m, device),
            )
        return out

    return _cache(pk, ("abc_coo", str(device)), build)


def _abc_h_w(pk: ProvingKey, w_mont: torch.Tensor):
    """Montgomery witness (B, m, L) -> (h_std (B, domain-1, L), w_std
    (B, m, L), sat (B,) bool): COO matvec + R1CS check + coset division."""
    f = fr_ops()
    ntt = get_ntt(pk.domain)
    coo = _abc_coo_device(pk, w_mont.device)
    n = pk.domain
    B = w_mont.shape[0]

    def matvec(name):
        rows, cols, c2m = coo[name]
        cw = f.mul(c2m[None], w_mont.index_select(1, cols))  # (B, nnz, L), canonical
        acc = torch.zeros((B, n, f.L), dtype=torch.int64, device=w_mont.device)
        # rows hold <= 254 terms (the largest LC is one packing chunk), so the
        # int64 lazy limb sums stay below 2^40
        acc.index_add_(1, rows, cw.to(torch.int64) & 0xFFFFFFFF)
        return f.reduce_lazy(acc)

    a_ev, b_ev, c_ev = matvec("a"), matvec("b"), matvec("c")
    # AB - C vanishes on every constraint row (past nc, B is identically 0)
    sat = f.is_zero(f.sub(f.mul(a_ev, b_ev), c_ev)).all(dim=-1)
    ca = ntt.coset_ntt(ntt.intt(a_ev))
    cb = ntt.coset_ntt(ntt.intt(b_ev))
    cc = ntt.coset_ntt(ntt.intt(c_ev))
    h_ev = f.mul(f.sub(f.mul(ca, cb), cc), ntt.table("zh_coset_inv", w_mont.device))
    h = ntt.coset_intt(h_ev)
    return f.from_mont(h)[:, : n - 1], f.from_mont(w_mont), sat


def devaff(pk: ProvingKey, name: str, device):
    """Device affine point tensors (x, y) of query `name` for the scheduled
    MSM; infinity is (0, 0).  G1 queries are zero-padded to one length, as
    in the JAX package (the scheduler sees the true scalar count)."""

    def build():
        pts = getattr(pk, f"{name}_pts")
        conv = ms.g2_affine_to_device if name == "b2" else ms.g1_affine_to_device
        arrs = conv(pts, "cpu")
        if name != "b2":
            pad = max(len(pk.a_pts), pk.domain - 1) - arrs[0].shape[0]
            if pad:
                arrs = tuple(torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in arrs)
        return tuple(a.to(device) for a in arrs)

    return _cache(pk, ("devaff", name, str(device)), build)


def _jac_dev(pk: ProvingKey, name: str, device):
    conv = co.g2_to_device if name == "b2" else co.g1_to_device
    return _cache(pk, ("jac", name, str(device)), lambda: conv(getattr(pk, f"{name}_pts"), device))


def _var_base_batch(pk: ProvingKey, name: str, group: str, limbs_list, device):
    """Complete-formula var-base MSM of every part (the fallback)."""
    digits = msm_mod.limbs_to_window_digits(torch.stack([lb.to_tensor(l, device) for l in limbs_list]))
    ops = co.g1_ops() if group == "g1" else co.g2_ops()
    return msm_mod.msm_var_base(ops, _jac_dev(pk, name, device), digits)


def prove_msms(pk: ProvingKey, w_std: torch.Tensor, h_std: torch.Tensor,
               window_bits: int = ms.DEFAULT_WINDOW_BITS, timer: StageTimer | None = None):
    """Five scheduled MSMs for B voters (standard-form scalar limbs on the
    device).  Returns ({query: Jacobian coords, leading dim (B,)}, number of
    var-base fallbacks taken)."""
    device = w_std.device
    w_np = lb.from_tensor(w_std)
    h_np = lb.from_tensor(h_std)
    w_limbs = list(w_np)
    aux_limbs = [wl[pk.num_primary + 1 :] for wl in w_limbs]
    h_limbs = list(h_np)
    sch_w = ms.build_schedule_multi(w_limbs, window_bits)
    sch_aux = ms.build_schedule_multi(aux_limbs, window_bits)
    sch_h = ms.build_schedule_multi(h_limbs, window_bits)
    ms.unify_schedule_shapes(sch_w, sch_aux)
    if timer:
        timer.mark("schedules")
    queries = (
        ("a", "g1", sch_w, w_limbs),
        ("b1", "g1", sch_w, w_limbs),
        ("b2", "g2", sch_w, w_limbs),
        ("l", "g1", sch_aux, aux_limbs),
        ("h", "g1", sch_h, h_limbs),
    )
    outs, fallbacks = {}, 0
    for name, group, sch, limbs_list in queries:
        res, exc = ms.msm_device(group, devaff(pk, name, device), sch)
        if bool(exc):  # madd doubling corner: recompute with complete formulas
            fallbacks += 1
            res = _var_base_batch(pk, name, group, limbs_list, device)
        outs[name] = res
        if timer:
            timer.mark(f"msm_{name}")
    return outs, fallbacks


def msms_from_device(outs: dict):
    """Device Jacobian MSM outputs -> host affine lists (a, b1, b2, l, h).
    The four G1 queries convert together."""
    g1 = [outs[k] for k in ("a", "b1", "l", "h")]
    B = g1[0][0].shape[0]
    pts = co.g1_from_device(tuple(torch.cat([q[k] for q in g1]) for k in range(3)))
    a, b1, l, h = (pts[i * B : (i + 1) * B] for i in range(4))
    return a, b1, co.g2_from_device(outs["b2"]), l, h


def prove(pk: ProvingKey, wvals: np.ndarray, rng: FrRandom, device="cpu",
          window_bits: int = ms.DEFAULT_WINDOW_BITS, timer: StageTimer | None = None) -> list[Proof]:
    """wvals: (B, num_vars) object ints (full assignments, column 0 == 1)."""
    w_mont = fr_ops().to_mont(lb.ints_to_tensor(wvals, lb.FR, device, mont=False))
    h_std, w_std, sat = _abc_h_w(pk, w_mont)
    if not bool(sat.all()):
        raise ValueError("witness does not satisfy the R1CS")
    if timer:
        timer.mark("abc_h")
    outs, fallbacks = prove_msms(pk, w_std, h_std, window_bits, timer)
    pts = msms_from_device(outs)
    proofs = _blind_and_assemble(pk, *pts, rng)
    if timer:
        timer.counts["fallbacks"] = timer.counts.get("fallbacks", 0) + fallbacks
        timer.mark("proof_assembly")
    return proofs


def _blind_and_assemble(pk, a_pts, b1_pts, b2_pts, l_pts, h_pts, rng):
    B = len(a_pts)
    rs = [(rng(), rng()) for _ in range(B)]
    d1 = rj.g1_mul_many(
        [pk.delta_g1] * (3 * B),
        [r for r, _ in rs] + [s for _, s in rs] + [r * s % R for r, s in rs],
    )
    d2 = rj.g2_mul_many([pk.delta_g2] * B, [s for _, s in rs])
    a_list, b1_list = [], []
    for i in range(B):
        a_list.append(rc.g1_add(rc.g1_add(pk.alpha_g1, a_pts[i]), d1[i]))
        b1_list.append(rc.g1_add(rc.g1_add(pk.beta_g1, b1_pts[i]), d1[B + i]))
    round2 = rj.g1_mul_many(a_list + b1_list, [s for _, s in rs] + [r for r, _ in rs])
    proofs = []
    for i in range(B):
        b2 = rc.g2_add(rc.g2_add(pk.beta_g2, b2_pts[i]), d2[i])
        c = rc.g1_add(l_pts[i], h_pts[i])
        c = rc.g1_add(c, round2[i])
        c = rc.g1_add(c, round2[B + i])
        c = rc.g1_add(c, rc.g1_neg(d1[2 * B + i]))
        proofs.append(Proof(a=a_list[i], b=b2, c=c))
    return proofs


# ---------------------------------------------------------------------------
# Verify (host pairings)
# ---------------------------------------------------------------------------


def ic_combine(vk: VerificationKey, primary: list[int]):
    return rc.g1_add(vk.ic[0], rj.msm_host(vk.ic[1 : 1 + len(primary)], primary))


def verify(vk: VerificationKey, primary: list[int], proof: Proof) -> bool:
    """e(A,B) == e(alpha,beta) * e(IC(primary), gamma) * e(C, delta)."""
    icp = ic_combine(vk, primary)
    return rp.pairing_check(
        [
            (proof.a, proof.b),
            (rc.g1_neg(vk.alpha_g1), vk.beta_g2),
            (rc.g1_neg(icp), vk.gamma_g2),
            (rc.g1_neg(proof.c), vk.delta_g2),
        ]
    )
