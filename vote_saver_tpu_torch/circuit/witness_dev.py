"""Device witness generation for the voting circuit.

Counterpart of ``vote_saver_tpu/circuit/witness_dev.py``: the host
object-int walk (``VotingCircuit.generate_witness``) becomes one batched
device program over voters, stage by stage:

  * Pedersen gadgets: digit gather from host-built window tables, a
    log-depth JubJub prefix scan over windows (``EdwardsOps.add``), ONE
    batched Fermat inversion for all intermediate affine points
    (``batch_inv_axis``), then batched multiplies for the EdwardsAdd
    internals (A, B, C, D, E, x3, y3);
  * digest decompositions: limb -> bit shifts, plus a cumulative product for
    the canonical sn comparison bits;
  * packings, Merkle selects and the one-hot vote: integer bit ops;

and every value scatters once into a (B, num_vars, L) Montgomery limb
tensor, the one ``groth16.prove_msms_device`` consumes.  Field multiplies
are kernel K1 on the card; field add/sub are the plain carry resolution of
``field_ops``.  The JAX package scans the Merkle levels as one stacked body;
here they are a Python loop over the levels.  The index programs are numpy
copies of the JAX module's (which imports jax) over this package's 32-bit
limb layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..params import CHUNK_SIZE, DIGEST_BITS, MSG_SIZE, SECRET_KEY_BITS
from ..ops import limbs as lb
from ..ops.curve_ops import jj_ops
from ..ops.field_ops import FieldOps, fr_ops

# ---------------------------------------------------------------------------
# Generic device helpers
# ---------------------------------------------------------------------------


def batch_inv_axis(f: FieldOps, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Invert every element along `axis` with ONE Fermat exponentiation:
    Hillis-Steele inclusive prefix and suffix products (log2 n multiply
    rounds), one f.inv of the total, then inv_i = pre_i * suf_i * total^-1.
    Zero entries give garbage (callers guarantee nonzero, as with f.inv)."""
    a = torch.movedim(a, axis, 0)
    n = a.shape[0]
    one = f.const("one_mont", a.device).expand_as(a)

    def scan_prod(x):
        if n == 1:
            return x
        idx = torch.arange(n, device=x.device).reshape((n,) + (1,) * (x.dim() - 1))
        for s in range((n - 1).bit_length()):
            shift = 1 << s
            x = f.mul(x, torch.where(idx >= shift, torch.roll(x, shift, dims=0), one))
        return x

    incl = scan_prod(a)
    pre = torch.cat([one[:1], incl[:-1]])  # exclusive prefix
    suf = torch.cat([scan_prod(a.flip(0)).flip(0)[1:], one[:1]])  # exclusive suffix
    out = f.mul(f.mul(pre, suf), f.inv(incl[-1])[None])
    return torch.movedim(out, 0, axis)


def bits_to_std_limbs(bits: torch.Tensor) -> torch.Tensor:
    """(B, nbits) 0/1 -> (B, L) int32 standard-form limbs (value < 2^nbits).

    Built in int64: bit 31 of a limb would overflow an int32 product."""
    L = lb.FR.num_limbs
    b = bits.to(torch.int64)
    b = F.pad(b, (0, 32 * L - b.shape[-1])).reshape(*b.shape[:-1], L, 32)
    v = (b << torch.arange(32, device=b.device)).sum(dim=-1)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def std_limbs_to_bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., L) int32 standard-form limbs -> (..., nbits) int64 bits (LE).
    A right shift of a negative int32 is arithmetic, so each bit is masked
    with & 1."""
    bits = (x[..., :, None] >> torch.arange(32, dtype=x.dtype, device=x.device)) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 32)[..., :nbits].to(torch.int64)


# ---------------------------------------------------------------------------
# Per-gadget host-side programs (index maps + constant tables)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PedersenProg:
    W: int
    nbits: int  # un-padded input bit count
    t_idx: np.ndarray  # (W,)
    xw_idx: np.ndarray  # (W,)
    add_idx: np.ndarray  # (W-1, 7): A,B,C,D,E,x3,y3
    xs4: np.ndarray  # (W, 4, L) uint32 Montgomery limbs
    ys4: np.ndarray  # (W, 4, L)


def _pedersen_prog(gadget, nbits: int) -> _PedersenProg:
    W = len(gadget.windows)
    t_idx = np.array([w[3] for w in gadget.windows], np.int64)
    xw_idx = np.array([w[4] for w in gadget.windows], np.int64)
    add_idx = np.array([[a.A, a.B, a.C, a.D, a.E, a.x3, a.y3] for a in gadget.adds], np.int64).reshape(-1, 7)
    xs4 = lb.ints_to_mont_limbs([[p[0] for p in row] for row in gadget.consts], lb.FR)
    ys4 = lb.ints_to_mont_limbs([[p[1] for p in row] for row in gadget.consts], lb.FR)
    return _PedersenProg(W, nbits, t_idx, xw_idx, add_idx, xs4, ys4)


@dataclasses.dataclass
class _DecompProg:
    bits_idx: np.ndarray  # (255,)
    canonical: bool
    lt_positions: np.ndarray  # (nset,) bit positions of R-1, MSB first
    lt_t_idx: np.ndarray  # (nset,)


def _decomp_prog(gadget) -> _DecompProg:
    bits_idx = np.array(gadget.bits, np.int64)
    if gadget.canonical:
        lt_positions = np.array([s[0] for s in gadget.lt_steps], np.int64)
        lt_t_idx = np.array([s[1] for s in gadget.lt_steps], np.int64)
    else:
        lt_positions = np.zeros(0, np.int64)
        lt_t_idx = np.zeros(0, np.int64)
    return _DecompProg(bits_idx, gadget.canonical, lt_positions, lt_t_idx)


@dataclasses.dataclass
class _Program:
    num_vars: int
    depth: int
    eid_bits: int
    m_idx: np.ndarray
    eid_bit_idx: np.ndarray
    sk_bit_idx: np.ndarray
    addr_idx: np.ndarray
    sib_idx: np.ndarray  # (depth, 255)
    eid_pack_idx: np.ndarray
    rt_pack_idx: np.ndarray
    sn_pack_idx: np.ndarray
    left_idx: np.ndarray  # (depth, 255)
    pk_hash: _PedersenProg
    pk_dec: _DecompProg
    leaf_hash: _PedersenProg
    leaf_dec: _DecompProg
    level_hash: list  # depth x _PedersenProg
    level_dec: list  # depth x _DecompProg
    sn_hash: _PedersenProg
    sn_dec: _DecompProg
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def tables(self, prog: _PedersenProg, device) -> tuple[torch.Tensor, torch.Tensor]:
        """A gadget's (xs4, ys4) window tables on `device` (copied once)."""
        key = (id(prog), str(device))
        if key not in self._dev:
            self._dev[key] = (lb.to_tensor(prog.xs4, device), lb.to_tensor(prog.ys4, device))
        return self._dev[key]


_prog_cache: dict = {}


def witness_program(circ) -> _Program:
    key = (circ.tree_depth, circ.eid_bits)
    if key in _prog_cache:
        return _prog_cache[key]
    p = circ._parts
    prog = _Program(
        num_vars=circ.cs.num_vars,
        depth=circ.tree_depth,
        eid_bits=circ.eid_bits,
        m_idx=np.arange(1, 1 + MSG_SIZE, dtype=np.int64),
        eid_bit_idx=np.array(p["eid_bit_vars"], np.int64),
        sk_bit_idx=np.array(p["sk_bit_vars"], np.int64),
        addr_idx=np.array(p["addr_vars"], np.int64),
        sib_idx=np.array(p["sib_vars"], np.int64),
        eid_pack_idx=np.array(p["eid_pack"].packed_vars, np.int64),
        rt_pack_idx=np.array(p["rt_pack"].packed_vars, np.int64),
        sn_pack_idx=np.array(p["sn_pack"].packed_vars, np.int64),
        left_idx=np.array([lvl.left for lvl in p["levels"]], np.int64),
        pk_hash=_pedersen_prog(p["pk_hash"], SECRET_KEY_BITS),
        pk_dec=_decomp_prog(p["pk_dec"]),
        leaf_hash=_pedersen_prog(p["leaf_hash"], DIGEST_BITS),
        leaf_dec=_decomp_prog(p["leaf_dec"]),
        level_hash=[_pedersen_prog(lvl.hash, 2 * DIGEST_BITS) for lvl in p["levels"]],
        level_dec=[_decomp_prog(lvl.decompose) for lvl in p["levels"]],
        sn_hash=_pedersen_prog(p["sn_hash"], circ.eid_bits + SECRET_KEY_BITS),
        sn_dec=_decomp_prog(p["sn_dec"]),
    )
    _prog_cache[key] = prog
    return prog


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


class _Collector:
    """Accumulates (var indices, values) pairs, scattered once into the
    witness tensor."""

    def __init__(self):
        self.bit_idx: list = []
        self.bit_vals: list = []
        self.field_idx: list = []
        self.field_vals: list = []

    def bits(self, idx: np.ndarray, vals: torch.Tensor) -> None:
        if idx.size:
            self.bit_idx.append(np.asarray(idx, np.int64).reshape(-1))
            self.bit_vals.append(vals.reshape(vals.shape[0], -1))

    def fields(self, idx: np.ndarray, vals: torch.Tensor) -> None:
        if idx.size:
            self.field_idx.append(np.asarray(idx, np.int64).reshape(-1))
            self.field_vals.append(vals.reshape(vals.shape[0], -1, vals.shape[-1]))

    def scatter(self, f: FieldOps, num_vars: int, B: int, device) -> torch.Tensor:
        one = f.const("one_mont", device)
        wit = torch.zeros((B, num_vars, f.L), dtype=torch.int32, device=device)
        wit[:, 0, :] = one
        bi = lb.upload(np.concatenate(self.bit_idx), device)
        bv = torch.cat(self.bit_vals, dim=1).to(torch.int32)
        wit[:, bi, :] = bv[..., None] * one
        fi = lb.upload(np.concatenate(self.field_idx), device)
        wit[:, fi, :] = torch.cat(self.field_vals, dim=1)
        return wit


def _pedersen_core(f: FieldOps, jj, xs4, ys4, bits, W: int):
    """The Pedersen gadget's values from its window tables.

    bits: (B, nbits <= 3W) 0/1; xs4/ys4: (W, 4, L) Montgomery limbs.
    Returns (t (B, W), xw (B, W, L), addvals (B, W-1, 7, L) or None,
    ax_last, ay_last)."""
    bits = F.pad(bits.to(torch.int64), (0, 3 * W - bits.shape[1]))
    s0, s1, s2 = bits[:, 0::3], bits[:, 1::3], bits[:, 2::3]  # (B, W)
    t = s0 * s1
    sel = s0 + 2 * s1
    warange = torch.arange(W, device=bits.device)[None, :]
    x_sel = xs4[warange, sel]  # (B, W, L)
    y_sel = ys4[warange, sel]
    xw = f.select(s2 == 1, f.neg(x_sel), x_sel)

    # extended coords of the window points; inclusive prefix sum over the
    # windows (partners before the start are the identity)
    ident = jj.identity_like(xw)
    pts = (xw, y_sel, ident[1], f.mul(xw, y_sel))  # X, Y, Z = 1, T = XY
    idx = torch.arange(W, device=bits.device).reshape(1, W, 1)
    for s in range((W - 1).bit_length()):
        shift = 1 << s
        shifted = tuple(torch.where(idx >= shift, torch.roll(c, shift, dims=1), i) for i, c in zip(ident, pts))
        pts = jj.add(pts, shifted)

    zinv = batch_inv_axis(f, pts[2], axis=1)
    ax, ay = f.mul(torch.stack([pts[0], pts[1]]), zinv).unbind(0)

    vals = None
    if W > 1:
        x1, y1 = ax[:, :-1], ay[:, :-1]
        x2, y2 = xw[:, 1:], y_sel[:, 1:]
        A, Bv, C, D = f.mul(torch.stack([x1, y1, x1, y1]), torch.stack([y2, x2, x2, y2])).unbind(0)
        E = f.mul(C, D)
        vals = torch.stack([A, Bv, C, D, E, ax[:, 1:], ay[:, 1:]], dim=2)
    return t, xw, vals, ax[:, -1], ay[:, -1]


def _run_pedersen(f, jj, prog: _Program, gp: _PedersenProg, bits, col: _Collector):
    """bits: (B, nbits).  Emits the gadget's t/xw/add vars; returns the
    digest point's affine x (B, L) Montgomery."""
    xs4, ys4 = prog.tables(gp, bits.device)
    t, xw, vals, ax_l, _ay_l = _pedersen_core(f, jj, xs4, ys4, bits, gp.W)
    col.bits(gp.t_idx, t)
    col.fields(gp.xw_idx, xw)
    if gp.add_idx.size:
        col.fields(gp.add_idx, vals)
    return ax_l


def _decompose_core(f: FieldOps, x_mont, lt_positions):
    """x_mont (B, L) -> (digest bits (B, 255), lt-chain t values or None)."""
    bits = std_limbs_to_bits(f.from_mont(x_mont), DIGEST_BITS)
    t_vals = None
    if lt_positions is not None and lt_positions.size:
        gathered = bits[:, lb.upload(lt_positions, bits.device)]
        t_vals = torch.cumprod(gathered, dim=1)
    return bits, t_vals


def _run_decompose(f, gd: _DecompProg, x_mont, col: _Collector):
    """x_mont (B, L) -> digest bits (B, 255); emits bit + lt-t vars."""
    bits, t_vals = _decompose_core(f, x_mont, gd.lt_positions if gd.canonical else None)
    col.bits(gd.bits_idx, bits)
    if gd.canonical:
        col.bits(gd.lt_t_idx, t_vals)
    return bits


def _run_packing(f, idx: np.ndarray, bits, col: _Collector) -> None:
    """bits (B, nbits) -> one packed field value per 254-bit chunk."""
    outs = [f.to_mont(bits_to_std_limbs(bits[:, k * CHUNK_SIZE : (k + 1) * CHUNK_SIZE]))
            for k in range(idx.shape[0])]
    col.fields(idx, torch.stack(outs, dim=1))


def _wgen(prog: _Program, vote_idx, eid_bits, sk_bits, addr_bits, sib_bits) -> torch.Tensor:
    """The whole witness from device tensors: vote_idx (B,), eid_bits
    (B, eid_bits), sk_bits (B, 255), addr_bits (B, depth), sib_bits
    (B, depth, 255)."""
    f, jj = fr_ops(), jj_ops()
    B, device = vote_idx.shape[0], vote_idx.device
    col = _Collector()
    col.bits(prog.m_idx, (vote_idx[:, None] == torch.arange(MSG_SIZE, device=device)[None, :]).to(torch.int64))
    col.bits(prog.eid_bit_idx, eid_bits)
    col.bits(prog.sk_bit_idx, sk_bits)
    col.bits(prog.addr_idx, addr_bits)
    col.bits(prog.sib_idx, sib_bits)

    _run_packing(f, prog.eid_pack_idx, eid_bits, col)

    pk_x = _run_pedersen(f, jj, prog, prog.pk_hash, sk_bits, col)
    pk_bits = _run_decompose(f, prog.pk_dec, pk_x, col)

    leaf_x = _run_pedersen(f, jj, prog, prog.leaf_hash, pk_bits, col)
    cur = _run_decompose(f, prog.leaf_dec, leaf_x, col)

    # the Merkle walk, bottom up: one level's digest feeds the next
    for k in range(prog.depth):
        addr = addr_bits[:, k : k + 1]
        sib = sib_bits[:, k]
        left = torch.where(addr == 1, sib, cur)
        right = torch.where(addr == 1, cur, sib)
        col.bits(prog.left_idx[k], left)
        lx = _run_pedersen(f, jj, prog, prog.level_hash[k], torch.cat([left, right], dim=1), col)
        cur = _run_decompose(f, prog.level_dec[k], lx, col)

    _run_packing(f, prog.rt_pack_idx, cur, col)

    sn_x = _run_pedersen(f, jj, prog, prog.sn_hash, torch.cat([eid_bits, sk_bits], dim=1), col)
    sn_bits = _run_decompose(f, prog.sn_dec, sn_x, col)
    _run_packing(f, prog.sn_pack_idx, sn_bits, col)

    return col.scatter(f, prog.num_vars, B, device)


def generate_witness_device(circ, vote_idx, eid_bits_le, sk_bits, voter_idx, sib_bits,
                            device="cuda") -> torch.Tensor:
    """Batched device witness; same inputs as VotingCircuit.generate_witness.
    Returns the (B, num_vars, L) Montgomery limb tensor on `device`."""
    device = lb.device_of(device)
    prog = witness_program(circ)
    vote = np.asarray(vote_idx, np.int64).reshape(-1)
    B = vote.shape[0]
    eid = np.broadcast_to(np.asarray(eid_bits_le).astype(np.int64), (B, circ.eid_bits))
    sk = np.asarray(sk_bits).astype(np.int64).reshape(B, SECRET_KEY_BITS)
    vidx = np.asarray(voter_idx, np.int64).reshape(-1)
    addr = (vidx[:, None] >> np.arange(circ.tree_depth)[None, :]) & 1
    sib = np.asarray(sib_bits).astype(np.int64).reshape(B, circ.tree_depth, DIGEST_BITS)
    return _wgen(prog, *(lb.upload(a, device) for a in (vote, eid, sk, addr, sib)))


def witness_to_host_ints(w_mont: torch.Tensor) -> np.ndarray:
    """(B, m, L) Montgomery limbs -> (B, m) object ints (for parity tests)."""
    return lb.tensor_to_ints(w_mont, lb.FR)
