"""Groth16 over BLS12-381: setup (host-native or on the device), the device
prover, host verify.

Counterpart of ``vote_saver_tpu/protocol/groth16.py``:

  * setup: QAP evaluation at tau, then the CRS by fixed-base
    multiplication, either native on the host (``device="host"``) or on the
    device (the default, the card) through ``FixedBaseTable`` (8-bit window gathers summed by the
    distinct-operand add K3d, in 2048-scalar chunks).  Both arms give the
    same CRS for the same ``FrRandom``;
  * prove: witness -> A/B/C by a COO matvec on the device (K1 multiplies,
    ``index_add_`` of int64 lazy limb columns, one ``reduce_lazy`` per row),
    the R1CS check, 3 iNTT + 3 coset NTT + 1 coset iNTT for H, then five
    scheduled MSMs (a/b1/l/h in G1, b2 in G2) with the B voters batched as
    parts and the var-base fallback on a flagged doubling corner.  The NTT
    path is an argument, ``ntt``: None takes ``ntt.choose_path``'s rule
    (the int8 matmul NTT on the card for domains of at least 2^12, else
    radix-2), "radix2" or "matmul" that path.
    ``prove_msms_device`` stops there and leaves the MSM outputs on the
    device for the device ballot tail, their five flags read in one
    deferred ``finish`` (``defer=True`` hands it to the caller, as the
    pipelined vote stream needs); ``prove`` (the host-witness arm)
    brings them to the host and blinds and assembles the proofs there;
  * verify: the 4-term pairing check on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..circuit.r1cs import ConstraintSystem
from ..params import FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from ..refimpl import curves as rc
from ..refimpl import jacobian as rj
from ..refimpl import pairing as rp
from ..utils.rng import FrRandom
from ..ops import curve_ops as co
from ..ops import hopper_field as hf
from ..ops import limbs as lb
from ..ops import msm as msm_mod
from ..ops import msm_sched as ms
from ..ops.field_ops import fr_ops
from ..ops.ntt import choose_path, get_ntt


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
    """Per-stage wall seconds, kernel launches (``launches[stage]``: the
    port's CUDA kernels launched in the stage) and event counts
    (``fallbacks``); synchronises the device at each mark so a stage's time
    includes its device work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.launches: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self._t = time.perf_counter()
        self._n = sum(hf.launches.values())

    def mark(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now, n = time.perf_counter(), sum(hf.launches.values())
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self.launches[stage] = self.launches.get(stage, 0) + n - self._n
        self._t, self._n = now, n


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

_FB_CHUNK = 2048
_fb_tables: dict = {}


def _fb_table(group: str) -> msm_mod.FixedBaseTable:
    if group not in _fb_tables:
        base = rc.g1_gen if group == "g1" else rc.g2_gen
        _fb_tables[group] = msm_mod.FixedBaseTable(base, group)
    return _fb_tables[group]


def _fixed_base_batch(group: str, scalars: list[int], device) -> list:
    """Fixed-base multiplication of many scalars on `device`; returns host
    affine points (None for a zero scalar).  On the card every scalar of
    the group goes in one window-sum launch and one affine conversion.  On
    the CPU (the plain versions) chunks of 2048 scalars, the last one
    zero-padded, as in the JAX package: every chunk's window sum is 5
    distinct adds over 32 x 2048 lanes."""
    table = _fb_table(group)
    ops = co.g1_ops() if group == "g1" else co.g2_ops()
    from_dev = co.g1_from_device if group == "g1" else co.g2_from_device
    if torch.device(device).type == "cuda":
        return from_dev(table.mul(ops, table.digits(scalars), device))
    out = []
    for off in range(0, len(scalars), _FB_CHUNK):
        chunk = scalars[off : off + _FB_CHUNK]
        padded = chunk + [0] * (_FB_CHUNK - len(chunk))
        out.extend(from_dev(table.mul(ops, table.digits(padded), device))[: len(chunk)])
    return out


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


def setup(cs: ConstraintSystem, rng: FrRandom, device="cuda") -> tuple[ProvingKey, VerificationKey]:
    """Groth16 keys; the CRS points come from native host fixed-base
    multiplication when `device` is "host", else from the device table on
    `device`."""
    if device != "host":
        device = lb.device_of(device)
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
    g1_scalars = u + v + h_exp + l_exp + ic_exp + [alpha, beta, delta]
    g2_scalars = v + [beta, gamma, delta]
    if device == "host":
        g1_points = rj.FixedBaseHost(rc.g1_gen, "g1").mul_many(g1_scalars)
        g2_points = rj.FixedBaseHost(rc.g2_gen, "g2").mul_many(g2_scalars)
    else:
        g1_points = _fixed_base_batch("g1", g1_scalars, device)
        g2_points = _fixed_base_batch("g2", g2_scalars, device)
    ofs = 0

    def take(k):
        nonlocal ofs
        out = g1_points[ofs : ofs + k]
        ofs += k
        return out

    a_pts, b1_pts, h_pts = take(m), take(m), take(domain - 1)
    l_pts, ic_pts = take(m - ni - 1), take(ni + 1)
    alpha_g1, beta_g1, delta_g1 = take(3)
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
    """pk._dev[key], built once; keys name their device by
    ``lb.device_of``, so "cuda" and "cuda:0" share one entry."""
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

    device = lb.device_of(device)
    return _cache(pk, ("abc_coo", str(device)), build)


def _abc_h_w(pk: ProvingKey, w_mont: torch.Tensor, ntt: str | None = None):
    """Montgomery witness (B, m, L) -> (h_std (B, domain-1, L), w_std
    (B, m, L), sat (B,) bool): COO matvec + R1CS check + coset division,
    the transforms on the NTT path `ntt` (``choose_path``)."""
    f = fr_ops()
    tr = get_ntt(pk.domain, choose_path(ntt, pk.domain, w_mont.device))
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
    ca = tr.coset_ntt(tr.intt(a_ev))
    cb = tr.coset_ntt(tr.intt(b_ev))
    cc = tr.coset_ntt(tr.intt(c_ev))
    h_ev = f.mul(f.sub(f.mul(ca, cb), cc), tr.table("zh_coset_inv", w_mont.device))
    h = tr.coset_intt(h_ev)
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

    device = lb.device_of(device)
    return _cache(pk, ("devaff", name, str(device)), build)


def _devaff_padded(pk: ProvingKey, name: str, d: int, device):
    """Device affine point tensors (x, y) of query `name` for a
    `points`-sharded MSM: the true point count (not ``devaff``'s
    length-unified G1 arrays, since the shards split the scalars by their
    own count, and the point shards must align with them) zero-padded to a
    multiple of `d` with (0, 0), the madd kernel's idle encoding."""

    def build():
        pts = getattr(pk, f"{name}_pts")
        conv = ms.g2_affine_to_device if name == "b2" else ms.g1_affine_to_device
        arrs = conv(pts + [None] * (-len(pts) % d), "cpu")
        return tuple(a.to(device) for a in arrs)

    device = lb.device_of(device)
    return _cache(pk, ("devaff_padded", name, d, str(device)), build)


def _jac_dev(pk: ProvingKey, name: str, device):
    device = lb.device_of(device)
    conv = co.g2_to_device if name == "b2" else co.g1_to_device
    return _cache(pk, ("jac", name, str(device)), lambda: conv(getattr(pk, f"{name}_pts"), device))


def _var_base_batch(pk: ProvingKey, name: str, group: str, limbs_list, device):
    """Complete-formula var-base MSM of every part (the fallback)."""
    digits = msm_mod.limbs_to_window_digits(torch.stack([lb.to_tensor(l, device) for l in limbs_list]))
    ops = co.g1_ops() if group == "g1" else co.g2_ops()
    return msm_mod.msm_var_base(ops, _jac_dev(pk, name, device), digits)


def prove_msms(pk: ProvingKey, w_std: torch.Tensor, h_std: torch.Tensor,
               window_bits: int = ms.DEFAULT_WINDOW_BITS, timer: StageTimer | None = None,
               defer: bool = False, mesh=None):
    """Five scheduled MSMs for B voters (standard-form scalar limbs on the
    device).  Returns (outs, w_np): outs maps each query to its Jacobian
    coords with leading dim (B,), w_np is the host copy of w_std that the
    schedules were built from.

    The MSMs are launched with their doubling-corner flags left on the
    device.  ``finish()`` reads the five flags with one host read, runs the
    complete-formula var-base MSM for each query whose flag is set
    (counted in ``timer.counts["fallbacks"]``) and returns outs; the
    timer's ``msm_*`` marks are made there.  defer=True returns
    (finish, w_np), so a pipelined caller can do other host work before
    the MSMs are waited for; defer=False returns (finish(), w_np).  With a
    `mesh` (``parallel.sharded.make_mesh``) the MSMs are point-sharded over
    its `points` axis (``_prove_msms_sharded``); every rank calls this with
    the same arguments and gets the same outs."""
    device = w_std.device
    w_np = lb.from_tensor(w_std)
    w_limbs = list(w_np)
    h_limbs = list(lb.from_tensor(h_std))
    if mesh is not None:
        queries, outs, excs = _prove_msms_sharded(pk, w_limbs, h_limbs, mesh, timer, window_bits)
    else:
        queries, outs, excs = _launch_msms(pk, w_limbs, h_limbs, device, timer, window_bits)

    def finish():
        flags = torch.stack(excs).tolist()  # the one host read of the five flags
        for (name, group, _sch, limbs_list), hit in zip(queries, flags):
            if hit:  # madd doubling corner: recompute with complete formulas
                outs[name] = _var_base_batch(pk, name, group, limbs_list, device)
            if timer:
                timer.mark(f"msm_{name}")
        if timer:
            timer.counts["fallbacks"] = timer.counts.get("fallbacks", 0) + sum(map(bool, flags))
        return outs

    return (finish if defer else finish()), w_np


def _queries(pk: ProvingKey, w_limbs, h_limbs, schedule):
    """The five queries (name, group, schedule, scalar limbs), `schedule`
    building each scalar set's schedule once."""
    aux_limbs = [wl[pk.num_primary + 1 :] for wl in w_limbs]
    sch_w, sch_aux, sch_h = schedule(w_limbs), schedule(aux_limbs), schedule(h_limbs)
    return (
        ("a", "g1", sch_w, w_limbs),
        ("b1", "g1", sch_w, w_limbs),
        ("b2", "g2", sch_w, w_limbs),
        ("l", "g1", sch_aux, aux_limbs),
        ("h", "g1", sch_h, h_limbs),
    )


def _launch_msms(pk: ProvingKey, w_limbs, h_limbs, device, timer, window_bits):
    """(queries, outs, flags) of the five MSMs on one device."""
    queries = _queries(pk, w_limbs, h_limbs, lambda limbs: ms.build_schedule_multi(limbs, window_bits))
    ms.unify_schedule_shapes(queries[0][2], queries[3][2])
    if timer:
        timer.mark("schedules")
    outs, excs = {}, []
    for name, group, sch, _limbs in queries:
        outs[name], exc = ms.msm_device(group, devaff(pk, name, device), sch)
        excs.append(exc)
    return queries, outs, excs


def _prove_msms_sharded(pk: ProvingKey, w_limbs, h_limbs, mesh, timer: StageTimer | None = None,
                        window_bits: int = ms.DEFAULT_WINDOW_BITS):
    """Point-sharded prover MSMs over the mesh's `points` axis: of D ranks,
    rank r owns rows [r*S, (r+1)*S) of every query (S = ceil(n / D) for its
    n points; ``_devaff_padded``) and builds only its own schedule, over
    its scalar slice zero-padded to S rows; the five MSMs run through
    ``sharded_msm_scheduled_fn``, each gathering the D partials and adding
    them in rank order.  Returns (queries, outs, flags) as ``prove_msms``'s
    finish reads them, each flag the count of ranks whose madd flagged."""
    from ..parallel import sharded

    d, r = sharded.axis_rank(mesh, "points")
    device = sharded.mesh_device(mesh)

    def own_schedule(limbs_list):
        s = -(-limbs_list[0].shape[0] // d)
        mine = [np.pad(l, ((0, d * s - l.shape[0]), (0, 0)))[r * s : (r + 1) * s] for l in limbs_list]
        return ms.build_schedule_multi(mine, window_bits)

    queries = _queries(pk, w_limbs, h_limbs, own_schedule)
    if timer:
        timer.mark("schedules")
    outs, excs = {}, []
    for name, group, sch, _limbs in queries:
        pts = _devaff_padded(pk, name, d, device)
        s = pts[0].shape[0] // d
        fn = sharded.sharded_msm_scheduled_fn(mesh, group, sch.num_windows, sch.window_bits, sch.num_parts)
        outs[name], exc = fn(tuple(c[r * s : (r + 1) * s] for c in pts), sch.codes, sch.merge_part, sch.merge_gather)
        excs.append(exc)
    return queries, outs, excs


def msms_from_device(outs: dict):
    """Device Jacobian MSM outputs -> host affine lists (a, b1, b2, l, h).
    The four G1 queries convert together."""
    g1 = [outs[k] for k in ("a", "b1", "l", "h")]
    B = g1[0][0].shape[0]
    pts = co.g1_from_device(tuple(torch.cat([q[k] for q in g1]) for k in range(3)))
    a, b1, l, h = (pts[i * B : (i + 1) * B] for i in range(4))
    return a, b1, co.g2_from_device(outs["b2"]), l, h


def prove_msms_device(pk: ProvingKey, w_mont: torch.Tensor, window_bits: int = ms.DEFAULT_WINDOW_BITS,
                      timer: StageTimer | None = None, ntt: str | None = None, defer: bool = False, mesh=None):
    """Montgomery witness (B, m, L) on the device -> (the five query MSMs as
    device Jacobian coords with leading dim (B,), w_std (B, m, L) standard
    form on the device, w_np its host copy), the NTTs on path `ntt`.  With
    defer=True the first item is ``prove_msms``'s zero-arg ``finish``, which
    gives the MSMs.  Read the primary inputs from w_np: a read of w_std
    would wait for the MSMs.  Raises ValueError if an assignment fails the
    R1CS.  With a `mesh` the five MSMs are point-sharded over its `points`
    axis (``prove_msms``)."""
    h_std, w_std, sat = _abc_h_w(pk, w_mont, ntt)
    if not bool(sat.all()):
        raise ValueError("witness does not satisfy the R1CS")
    if timer:
        timer.mark("abc_h")
    outs, w_np = prove_msms(pk, w_std, h_std, window_bits, timer, defer=defer, mesh=mesh)
    return outs, w_std, w_np


def prove(pk: ProvingKey, wvals: np.ndarray, rng: FrRandom, device="cuda",
          window_bits: int = ms.DEFAULT_WINDOW_BITS, timer: StageTimer | None = None,
          ntt: str | None = None) -> list[Proof]:
    """wvals: (B, num_vars) object ints (full assignments, column 0 == 1);
    `ntt` the NTT path (``choose_path``)."""
    device = lb.device_of(device)
    w_mont = fr_ops().to_mont(lb.ints_to_tensor(wvals, lb.FR, device, mont=False))
    outs, _w_std, _w_np = prove_msms_device(pk, w_mont, window_bits, timer, ntt)
    proofs = _blind_and_assemble(pk, *msms_from_device(outs), rng)
    if timer:
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
