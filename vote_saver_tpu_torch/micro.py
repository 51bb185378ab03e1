"""The multiply probes K7-K10 on the card, and their plain versions.

Counterparts of the JAX package's probe kernels, each a hand-written CUDA
kernel in ``csrc/micro.cu``:

  K7  ``field_mul(mode)``            <- bench.py:bench_field_mul: 4 chains x
      6 chained Fq multiplies; reports ``fq_mul_mps``;
  K8  ``cios_loop(variants)``        <- scripts/micro_cios_loop.py: 4 x 8,
      loop against v1, with each variant's registers, local (spill) bytes
      and build seconds — register pressure is what this card pays for
      code size, where the TPU paid compile time;
  K9  ``op_throughput()``            <- scripts/micro_vpu2.py: one primitive
      op kind unrolled 512 deep, Giter/s and Gop/s per kind, plus
      ``u32_mul_wide``, the 32x32->64 multiply-add that every curve kernel
      is bound by (the card's data sheet gives no rate for it); each
      integer kind also runs as 8 independent chains per lane (``_x8``),
      its throughput where the single chain measures its latency;
  K10 ``mul_chain(modes)``           <- scripts/micro_mul_chain.py: one
      dependent chain of 16, v1 against fold (multiply latency);

the fold instances of K7 and K10 run the fold product on the int8 tensor
cores, a warp's 32 lanes as one tile (``csrc/fold_mma.cuh``; its B operand
``fold_mul.mma_operand`` is uploaded once per card), the others one lane
to a thread;

and ``mont_mul_modes()``, kernel K1 in each multiplier mode at full width.
Each chain probe checks parity on several lanes against the host oracle
(``want = want * y * R^-1 mod Q``) at the JAX probes' shape, 14 x 8 x 128 =
14,336 lanes, and times at 2^20 lanes, which fills the card; on the card
the timed 2^20-lane launch is also held against the plain version on every
lane and against the oracle on a sample.  K9 times the JAX probe's constant
inputs and checks a launch with different inputs in every lane.  The plain
PyTorch version of each kernel is what a CPU tensor runs.

Entry points run on the card unless the caller names another device; the
rates exist only there.  On the card:

    python -m vote_saver_tpu_torch.micro
"""

from __future__ import annotations

import fractions
import json
import math
import random
import re
import subprocess

import numpy as np
import torch

from .ops import fold_mul
from .ops import hopper_field as hf
from .ops import limbs as lb
from .params import Q

# name -> (index in csrc/micro.cu kChains, mode, chains, unroll)
CHAIN_PROBES = {
    "k7_loop": (0, "loop", 4, 6),
    "k7_v1": (1, "v1", 4, 6),
    "k7_fold": (2, "fold", 4, 6),
    "k8_loop": (3, "loop", 4, 8),
    "k8_v1": (4, "v1", 4, 8),
    "k10_v1": (5, "v1", 1, 16),
    "k10_fold": (6, "fold", 1, 16),
}
# K9 kind -> ops per iteration (micro_vpu2.OPS_PER_ITER, plus u32_mul_wide
# and the 8-chain forms of the integer kinds); the order is csrc/micro.cu's
# kOps
OP_KINDS = {
    "u32_mul": 2, "u32_mulmask": 3, "u32_shift_add": 3,
    "f32_fma": 1, "f32_mul_add": 2, "cvt_f32_u32": 1.5, "u32_mul_wide": 2,
    "u32_mul_x8": 2, "u32_mulmask_x8": 3, "u32_shift_add_x8": 3, "u32_mul_wide_x8": 2,
}
OP_UNROLL = 512  # iterations per lane, over all of its chains
OP_CHAINS = {k: 8 if k.endswith("_x8") else 1 for k in OP_KINDS}
PLAIN_CHUNK = 1 << 18  # lanes per call of a plain multiply at full width
PARITY_LANES = 14 * 8 * 128  # the JAX probes' (14 tiles x 8 x 128) shape
FULL_LANES = 1 << 20
_K8_TYPES = {"loop": "MulLoop", "v1": "MulV1"}

KERNELS = tuple(f"mul_chain_{k}" for k in CHAIN_PROBES) + tuple(f"op_{k}" for k in OP_KINDS)
REPLACES = {f"mul_chain_{k}": ("bench.py:302" if k.startswith("k7") else
                               "scripts/micro_cios_loop.py:108" if k.startswith("k8") else
                               "scripts/micro_mul_chain.py:59") for k in CHAIN_PROBES}
REPLACES.update({f"op_{k}": "scripts/micro_vpu2.py:53" for k in OP_KINDS})
MUL_WIDE_KINDS = ("u32_mul_wide", "u32_mul_wide_x8")
# NVIDIA's CUDA C++ Programming Guide, "Arithmetic Instructions" (throughput
# of native arithmetic instructions), compute capability 9.0: 64 results per
# clock per SM of 32-bit integer multiply, multiply-add and extended-precision
# multiply-add.  A 32x32->64 multiply-add writes two 32-bit results (mad.lo
# and mad.hi), so it counts as two.
GUIDE_INT32_MUL_PER_SM_CLOCK = 64
# NVIDIA H100 Tensor Core GPU Architecture whitepaper: an SM has four
# processing blocks, each issuing one warp instruction (32 threads) per clock
ISSUE_PER_SM_CLOCK = 4 * 32
SOURCES = dict.fromkeys(KERNELS, "vote_saver_tpu_torch/csrc/micro.cu")
launches = dict.fromkeys(KERNELS, 0)

_M32 = 0xFFFFFFFF
_RINV = pow(lb.FQ.mont_r, -1, Q)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Kernel wrappers and plain versions
# ---------------------------------------------------------------------------


def mul_chain_plain(mode: str, chains: int, unroll: int, x: torch.Tensor, y: torch.Tensor):
    """Chain k of lane i starts at x[(i + k) % n]; `unroll` rounds multiply
    every chain by y.  -> (chain 0, field sum of chains 1.. or None).  Runs
    PLAIN_CHUNK lanes at a time: the plain multiply's intermediates are
    kilobytes per lane."""
    starts = [x] + [torch.roll(x, -k, dims=0) for k in range(1, chains)]
    fq = hf.HALF["fq"]
    out0, out1 = [], []
    for lo in range(0, x.shape[0], PLAIN_CHUNK):
        cs, yc = [c[lo : lo + PLAIN_CHUNK] for c in starts], y[lo : lo + PLAIN_CHUNK]
        for _ in range(unroll):
            cs = [hf.mont_mul_plain("fq", c, yc, mode) for c in cs]
        out0.append(cs[0])
        if chains > 1:
            rest = hf._half(cs[1])
            for c in cs[2:]:
                rest = fq.add(rest, hf._half(c))
            out1.append(hf._pack(rest))
    return torch.cat(out0), (torch.cat(out1) if chains > 1 else None)


def run_chain(probe: str, x: torch.Tensor, y: torch.Tensor):
    """One launch of chain probe `probe` (K7, K8 or K10) on (n, 12) int32 Fq
    limbs -> (chain 0, field sum of chains 1.. or None)."""
    idx, mode, chains, unroll = CHAIN_PROBES[probe]
    if not hf._on_cuda(x):
        return mul_chain_plain(mode, chains, unroll, x, y)
    n = x.shape[0]
    hf._check((x, y), (lb.FQ.num_limbs,), n, x.device)
    out0, out1 = torch.empty_like(x), torch.empty_like(x)
    lib = hf._lib()
    if mode == "fold":
        hf.upload_fold_matrix(lib.vs_micro_fold_mma_upload, 0, x.device, fold_mul.mma_operand)
    name = f"mul_chain_{probe}"
    hf._raise_on(lib.vs_mul_chain(idx, x.data_ptr(), y.data_ptr(), out0.data_ptr(), out1.data_ptr(), n,
                                  hf._stream(x.device)), name)
    launches[name] += 1
    return out0, (out1 if chains > 1 else None)


def chain_info(probe: str, device="cuda") -> dict:
    """hopper_field.kernel_info of chain probe `probe`'s instance."""
    return hf.kernel_info(hf._lib().vs_mul_chain_info, CHAIN_PROBES[probe][0], f"mul_chain_{probe}", device)


def _f32_round(v: fractions.Fraction) -> float:
    """A rational -> the nearest float32 (ties to even; inf past the top)."""
    if v == 0:
        return 0.0
    sign, v = (-1.0, -v) if v < 0 else (1.0, v)
    e = math.floor(math.log2(v))
    while v >= fractions.Fraction(2) ** (e + 1):
        e += 1
    while v < fractions.Fraction(2) ** e:
        e -= 1
    e = max(e, -126)
    scaled = v / fractions.Fraction(2) ** (e - 23)
    m = math.floor(scaled)
    rem = scaled - m
    if rem > fractions.Fraction(1, 2) or (rem == fractions.Fraction(1, 2) and m % 2):
        m += 1
    out = m * 2.0 ** (e - 23)
    return sign * (math.inf if out >= 2.0 ** 128 else out)


def _base(kind: str) -> str:
    return kind[: -len("_x8")] if kind.endswith("_x8") else kind


def op_oracle(kind: str, x: int, y: int) -> int:
    """Host oracle of K9 for one lane: bit patterns in and out (u32).  An
    integer kind runs OP_CHAINS[kind] chains, chain j from x + j with the
    constants y + chains * r + j, and returns the sum of their results."""
    if kind.startswith("f32"):
        xf = float(np.array([x], np.uint32).view(np.float32)[0])
        yf = float(np.array([y], np.uint32).view(np.float32)[0])
        for k in range(OP_UNROLL):
            # an infinity has no Fraction: it goes on in float arithmetic,
            # which keeps its sign exactly
            if kind == "f32_fma":
                xf = xf * yf + k if math.isinf(xf) else _f32_round(
                    fractions.Fraction(xf) * fractions.Fraction(yf) + k)
            else:
                yk = _f32_round(fractions.Fraction(yf) + k)
                xf = xf * yk if math.isinf(xf) else _f32_round(fractions.Fraction(xf) * fractions.Fraction(yk))
        return int(np.array([xf], np.float32).view(np.uint32)[0])
    if kind == "cvt_f32_u32":
        for k in range(OP_UNROLL // 2):
            x = int(np.float32((x + k) & _M32))
        return x
    base, chains = _base(kind), OP_CHAINS[kind]
    total = 0
    for j in range(chains):
        xj = w = (x + j) & _M32
        for r in range(OP_UNROLL // chains):
            yk = (y + chains * r + j) & _M32
            if base == "u32_mul":
                xj = xj * yk & _M32
            elif base == "u32_mulmask":
                xj = xj * yk & 0xFFFF
            elif base == "u32_shift_add":
                xj = ((xj >> 1) + yk) & _M32
            else:
                w = (w & _M32) * yk + (w >> 32)
        total += (w & _M32) if base == "u32_mul_wide" else xj
    return total & _M32


def _fma_f32(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """float32 x * y + k rounded once, as fmaf does: the product is exact in
    float64, the sum is rounded to odd in float64 (its TwoSum error says
    which way), and float64 rounded to odd then to the nearest float32 is
    the correctly rounded float32, since 53 >= 2 * 24 + 2."""
    p = x.to(torch.float64) * y.to(torch.float64)
    s = p + k
    bb = s - p
    err = (p - (s - bb)) + (k - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, math.inf)
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def op_plain(kind: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain K9 on (n,) int32 bit patterns (float kinds: float32 bits)."""
    if kind.startswith("f32"):
        xf, yf = x.view(torch.float32), y.view(torch.float32)
        for k in range(OP_UNROLL):
            xf = _fma_f32(xf, yf, k) if kind == "f32_fma" else xf * (yf + k)
        return xf.view(torch.int32)
    xv, yv = x.to(torch.int64) & _M32, y.to(torch.int64) & _M32
    if kind == "cvt_f32_u32":
        for k in range(OP_UNROLL // 2):
            xv = ((xv + k) & _M32).to(torch.float32).to(torch.int64)
        out = xv
    else:
        base, chains = _base(kind), OP_CHAINS[kind]
        out = torch.zeros_like(xv)
        for j in range(chains):
            xj = lo = (xv + j) & _M32
            hi = torch.zeros_like(xv)
            for r in range(OP_UNROLL // chains):
                yk = (yv + chains * r + j) & _M32
                if base == "u32_mul":
                    xj = (xj * yk) & _M32  # int64 wraps mod 2^64; the low 32 bits are exact
                elif base == "u32_mulmask":
                    xj = (xj * yk) & 0xFFFF
                elif base == "u32_shift_add":
                    xj = ((xj >> 1) + yk) & _M32
                else:
                    # lo * yk + hi, exactly, on 16-bit halves of yk
                    p0, p1 = lo * (yk & 0xFFFF), lo * (yk >> 16)
                    t = (p0 & _M32) + ((p1 & 0xFFFF) << 16)
                    s = (t & _M32) + hi
                    hi = (p0 >> 32) + (p1 >> 16) + (t >> 32) + (s >> 32)
                    lo = s & _M32
            out = out + (lo if base == "u32_mul_wide" else xj)
        out = out & _M32
    return (out - ((out >> 31) << 32)).to(torch.int32)


def op_inputs(kind: str, lanes: int, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """K9's parity inputs, a different (x, y) in every lane (uint32 bit
    patterns), drawn so that every lane's result depends on its own inputs:
    f32_fma with |y| < 1, so x * y + k stays finite; f32_mul_add with
    y = -(m + 1/2), so y + k is never 0 and the product overflows to an
    infinity whose sign is x's times (-1)^(m + 1); cvt_f32_u32 with
    x < 2^31, far below 2^32, which a conversion back cannot hold.  Only
    u32_mul and u32_mulmask give 0 in every lane whatever the inputs (512
    consecutive factors y + k hold 2^32); their _x8 forms, whose chains
    step the constants by 8, keep the lanes apart."""
    g = np.random.default_rng(seed)
    if kind == "f32_fma":
        x, y = g.uniform(0.5, 2.0, lanes), g.uniform(-0.99, 0.99, lanes)
    elif kind == "f32_mul_add":
        x, y = g.choice([-1.0, 1.0], lanes) * g.uniform(0.5, 2.0, lanes), -(g.integers(0, OP_UNROLL, lanes) + 0.5)
    else:
        top = 1 << (31 if kind == "cvt_f32_u32" else 32)
        return g.integers(0, top, lanes, dtype=np.uint64).astype(np.uint32), g.integers(
            0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    return x.astype(np.float32).view(np.uint32), y.astype(np.float32).view(np.uint32)


def run_op(kind: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One launch of K9 for `kind` on (n,) int32 bit patterns."""
    if not hf._on_cuda(x):
        return op_plain(kind, x, y)
    n = x.shape[0]
    if x.dtype != torch.int32 or y.dtype != torch.int32 or x.shape != (n,) or y.shape != (n,):
        raise ValueError("K9 takes (n,) int32 bit patterns")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    name = f"op_{kind}"
    hf._raise_on(hf._lib().vs_op(list(OP_KINDS).index(kind), x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                                 hf._stream(x.device)), name)
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# The probes
# ---------------------------------------------------------------------------


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), its milliseconds on the card) for one call."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(pairs) -> int:
    """Largest |u - v| over pairs of int32 tensors read as uint32 words."""
    return max(int(((u.to(torch.int64) & _M32) - (v.to(torch.int64) & _M32)).abs().max()) for u, v in pairs)


def card_int_rates(k9: dict) -> dict:
    """The integer rates, per second, that the bounds divide by, from
    per-SM-per-clock figures times the SM count and the maximum SM clock
    nvidia-smi reports: ``mul_wide``, 32x32->64 multiply-adds, the larger of
    the Programming Guide's GUIDE_INT32_MUL_PER_SM_CLOCK / 2 and the faster
    u32_mul_wide form K9 measured; ``mul32``, 32-bit multiplies, the
    guide's GUIDE_INT32_MUL_PER_SM_CLOCK; ``issue``, instructions of any
    kind, ISSUE_PER_SM_CLOCK."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    clock_hz = float(out.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mul32 = GUIDE_INT32_MUL_PER_SM_CLOCK * sms * clock_hz
    k9_wide = max(k9[k]["giter_s"] for k in MUL_WIDE_KINDS) * 1e9
    return dict(sms=sms, clock_hz=clock_hz, guide_mul_wide=mul32 / 2, k9_mul_wide=k9_wide,
                mul_wide=max(mul32 / 2, k9_wide), mul32=mul32, issue=ISSUE_PER_SM_CLOCK * sms * clock_hz)


def random_limbs(name: str, n: int, device, gen: torch.Generator | None = None) -> torch.Tensor:
    """n canonical elements as (n, L) int32 limbs, drawn on `device`: random
    limbs with the top limb cut below the modulus's."""
    spec = lb.spec_for(name)
    x = torch.randint(-(1 << 31), 1 << 31, (n, spec.num_limbs), dtype=torch.int32, device=device, generator=gen)
    top_bits = (spec.modulus >> (32 * (spec.num_limbs - 1))).bit_length() - 1
    x[:, -1] &= (1 << top_bits) - 1
    return x


def _parity_inputs(lanes: int, device):
    rnd = random.Random(7)
    xs = [rnd.randrange(Q) for _ in range(lanes)]
    ys = [rnd.randrange(Q) for _ in range(lanes)]
    # raw limbs, as the JAX probes load them: chain 0 ends at x * (y R^-1)^depth
    return xs, ys, lb.ints_to_tensor(xs, lb.FQ, device, mont=False), lb.ints_to_tensor(ys, lb.FQ, device, mont=False)


def _check_lanes(lanes: int) -> list[int]:
    """The lanes held against the host oracle: both ends, the middle, and a
    seeded sample of the rest."""
    fixed = {0, 1, 2, lanes // 2, lanes - 1} & set(range(lanes))
    return sorted(fixed | set(random.Random(lanes).sample(range(lanes), min(lanes, 11))))


def _chain_oracle(probe: str, lanes, xs, ys, got, depth: int) -> None:
    """Chain 0 of each lane in `lanes` ends at x * (y R^-1)^depth."""
    for lane, x, y, g in zip(lanes, xs, ys, got):
        if g != x * pow(y * _RINV % Q, depth, Q) % Q:
            raise AssertionError(f"{probe} parity fails at lane {lane}")


def chain_probe(probe: str, device="cuda", lanes: int = FULL_LANES, parity_lanes: int = PARITY_LANES,
                reps: int = 20) -> dict:
    """Run chain probe `probe` (K7, K8 or K10): parity at `parity_lanes`
    (reps launches fed back, chain 0 against the host oracle on several
    lanes; on the card also the kernel against its plain version for one
    launch), then, on the card, M mul/s at `lanes`, that launch held
    against the plain version on every lane (``plain_ms`` is its time) and
    against the host oracle on a sample."""
    device = lb.device_of(device)
    _idx, mode, chains, unroll = CHAIN_PROBES[probe]
    xs, ys, a, b = _parity_inputs(parity_lanes, device)
    x = a
    for _ in range(reps):
        x, _rest = run_chain(probe, x, b)
    idx = _check_lanes(parity_lanes)
    _chain_oracle(probe, idx, [xs[i] for i in idx], [ys[i] for i in idx],
                  lb.tensor_to_ints(x[idx], lb.FQ, mont=False), reps * unroll)
    out = dict(probe=probe, mode=mode, chains=chains, unroll=unroll, parity_lanes=parity_lanes,
               parity_depth=reps * unroll, parity=True, device=str(device))
    if device.type != "cuda":
        return out
    k0, k1 = run_chain(probe, a, b)
    p0, p1 = mul_chain_plain(mode, chains, unroll, a, b)
    err = max_abs_err([(k0, p0)] + ([(k1, p1)] if chains > 1 else []))
    gen = torch.Generator(device=device).manual_seed(7)
    fa, fb = random_limbs("fq", lanes, device, gen), random_limbs("fq", lanes, device, gen)
    out["lanes"] = lanes
    out["ms"] = time_ms(lambda: run_chain(probe, fa, fb), reps)
    out["mul_mps"] = lanes * chains * unroll / out["ms"] / 1e3
    k0, k1 = run_chain(probe, fa, fb)
    (p0, p1), out["plain_ms"] = timed(lambda: mul_chain_plain(mode, chains, unroll, fa, fb))
    out["max_abs_err"] = max(err, max_abs_err([(k0, p0)] + ([(k1, p1)] if chains > 1 else [])))
    if out["max_abs_err"]:
        raise AssertionError(f"{probe} kernel disagrees with its plain version")
    idx = _check_lanes(lanes)
    _chain_oracle(probe, idx, *(lb.tensor_to_ints(t[idx], lb.FQ, mont=False) for t in (fa, fb, k0)), unroll)
    out.update(chain_info(probe, device))
    return out


def field_mul(mode: str = "loop", device="cuda", **kw) -> dict:
    """K7: 4 independent chains x 6 chained Fq multiplies in `mode`;
    ``fq_mul_mps`` is bench.py's metric."""
    out = chain_probe(f"k7_{mode}", device, **kw)
    if "mul_mps" in out:
        out["fq_mul_mps"] = out["mul_mps"]
    return out


def cios_loop(variants=("loop", "v1"), device="cuda", **kw) -> dict:
    """K8: loop against v1 (4 chains x 8); on the card also the seconds of a
    build of each variant alone, and its registers and spill bytes as
    ptxas reports them for that build (-Xptxas -v)."""
    from .ops import _build

    res = {}
    for v in variants:
        r = chain_probe(f"k8_{v}", device, **kw)
        if r["device"].startswith("cuda"):
            r["build_s"], usage = _build.compile_seconds("micro.cu", ("VS_K8_ONLY=1", f"VS_K8_MUL={_K8_TYPES[v]}"))
            regs = re.search(r"Used (\d+) registers", usage)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", usage)
            if not (regs and spill):
                raise RuntimeError(f"no ptxas resource report for K8 {v}:\n{usage}")
            r["registers"] = int(regs.group(1))
            r["spill_stores"], r["spill_loads"] = int(spill.group(1)), int(spill.group(2))
        res[v] = r
    return res


def mul_chain(modes=("v1", "fold"), device="cuda", **kw) -> dict:
    """K10: one dependent chain of 16 multiplies per lane (latency)."""
    return {m: chain_probe(f"k10_{m}", device, **kw) for m in modes}


def op_throughput(device="cuda", lanes: int = FULL_LANES, reps: int = 10, kinds=tuple(OP_KINDS)) -> dict:
    """K9: Giter/s and Gop/s per op kind at `lanes`, timed on the JAX
    probe's inputs (x = 1, y = 3; float kinds the bit patterns of 1.0 and
    3.0), every lane of that launch against the host oracle.  A second
    launch with a different (x, y) in every lane (``op_inputs``) is held
    against the host oracle on a sample of lanes and, on the card, against
    the plain version on every lane (``plain_ms`` is its time)."""
    device = lb.device_of(device)
    res = {}
    for kind in kinds:
        flt = kind.startswith("f32")
        x0, y0 = (0x3F800000, 0x40400000) if flt else (1, 3)
        x = torch.full((lanes,), x0, dtype=torch.int32, device=device)
        y = torch.full((lanes,), y0, dtype=torch.int32, device=device)
        got = run_op(kind, x, y)
        want = op_oracle(kind, x0, y0)
        if not bool((got == (want - ((want >> 31) << 32))).all()):
            raise AssertionError(f"K9 {kind} disagrees with the host oracle on the JAX probe's inputs")
        xs, ys = op_inputs(kind, lanes)
        px, py = (torch.from_numpy(v.view(np.int32)).to(device) for v in (xs, ys))
        pgot = run_op(kind, px, py)
        idx = _check_lanes(lanes)
        if pgot[idx].cpu().numpy().view(np.uint32).tolist() != [op_oracle(kind, int(xs[i]), int(ys[i])) for i in idx]:
            raise AssertionError(f"K9 {kind} disagrees with the host oracle on per-lane inputs")
        r = dict(kind=kind, lanes=lanes, unroll=OP_UNROLL, chains=OP_CHAINS[kind], ops_per_iter=OP_KINDS[kind],
                 parity=True, device=str(device))
        if device.type == "cuda":
            plain, r["plain_ms"] = timed(lambda: op_plain(kind, px, py))
            r["max_abs_err"] = max_abs_err([(pgot, plain)])
            if r["max_abs_err"]:
                raise AssertionError(f"K9 {kind} kernel disagrees with its plain version")
            r["ms"] = time_ms(lambda: run_op(kind, x, y), reps)
            # counted as the JAX probe counts them (cvt: 256 loops of 3 ops
            # = 512 iterations of 1.5)
            r["giter_s"] = lanes * OP_UNROLL / r["ms"] / 1e6
            r["gop_s"] = r["giter_s"] * OP_KINDS[kind]
        res[kind] = r
    return res


def mont_mul_modes(device="cuda", lanes: int = FULL_LANES, reps: int = 20) -> dict:
    """K1 in each multiplier mode, Fq and Fr: every lane equal to the loop
    mode's and to the plain version's, a sample against Python integers;
    on the card M mul/s at `lanes`."""
    device = lb.device_of(device)
    res = {}
    gen = torch.Generator(device=device).manual_seed(11)
    for name in ("fq", "fr"):
        spec = lb.spec_for(name)
        a, b = random_limbs(name, lanes, device, gen), random_limbs(name, lanes, device, gen)
        ref = hf.mont_mul(name, a, b, "loop")
        idx = _check_lanes(lanes)
        xs, ys = lb.tensor_to_ints(a[idx], spec), lb.tensor_to_ints(b[idx], spec)
        for mode in hf.MODES:
            got = hf.mont_mul(name, a, b, mode)
            plain = torch.cat([hf.mont_mul_plain(name, a[i : i + PLAIN_CHUNK], b[i : i + PLAIN_CHUNK], mode)
                               for i in range(0, lanes, PLAIN_CHUNK)])
            err = max_abs_err([(got, plain)])
            if err or not torch.equal(got, ref) or list(lb.tensor_to_ints(got[idx], spec)) != [
                    x * y % spec.modulus for x, y in zip(xs, ys)]:
                raise AssertionError(f"K1 {name} in mode {mode} disagrees")
            r = dict(field=name, mode=mode, lanes=lanes, parity=True, max_abs_err=err, device=str(device))
            if device.type == "cuda":
                r["ms"] = time_ms(lambda: hf.mont_mul(name, a, b, mode), reps)
                r["mul_mps"] = lanes / r["ms"] / 1e3
            res[f"{name}_{mode}"] = r
    return res


def run_all(device="cuda") -> dict:
    """Every probe on the card, in the order K9 (the yardstick), K1 by mode,
    K7, K8, K10, and the integer rates the bounds use (``rates``)."""
    k9 = op_throughput(device)
    return dict(
        op_throughput=k9,
        rates=card_int_rates(k9),
        mont_mul_modes=mont_mul_modes(device),
        field_mul={m: field_mul(m, device) for m in hf.MODES},
        cios_loop=cios_loop(device=device),
        mul_chain=mul_chain(device=device),
    )


def report_lines(res: dict, gpu: str) -> list[str]:
    """One line per probe result, each with the card's name and power limit."""
    lines = []
    k9 = res["op_throughput"]
    for kind, r in k9.items():
        lines.append(f"[K9] {kind}: {r['giter_s']:.1f} Giter/s = {r['gop_s']:.1f} Gop/s "
                     f"({r['ops_per_iter']} ops/iter, {r['chains']} chain(s), {r['lanes']} lanes x {r['unroll']}); "
                     f"parity ok, per-lane launch equal to plain; {gpu}")
    rt = res["rates"]
    wide = " / ".join(f"{k} {k9[k]['giter_s']:.1f}" for k in MUL_WIDE_KINDS)
    lines.append(f"[rates] 32x32->64 multiply-adds: {rt['mul_wide'] / 1e12:.3f} T/s, the larger of the "
                 f"Programming Guide's {rt['guide_mul_wide'] / 1e12:.3f} ({GUIDE_INT32_MUL_PER_SM_CLOCK // 2}/clock/SM"
                 f" x {rt['sms']} SMs x {rt['clock_hz'] / 1e6:.0f} MHz) and K9's {rt['k9_mul_wide'] / 1e12:.3f} "
                 f"({wide} Giter/s); 32-bit multiplies {rt['mul32'] / 1e12:.3f} T/s "
                 f"({GUIDE_INT32_MUL_PER_SM_CLOCK}/clock/SM); instruction issue {rt['issue'] / 1e12:.3f} T/s "
                 f"({ISSUE_PER_SM_CLOCK}/clock/SM); {gpu}")
    for key, r in res["mont_mul_modes"].items():
        lines.append(f"[K1] {key}: {r['mul_mps']:.1f} M mul/s ({r['ms']:.4f} ms at {r['lanes']} lanes); "
                     f"equal to loop and to plain on every lane; {gpu}")
    chains = [("K7", f"field_mul {m} (fq_mul_mps)", r, "4 chains x 6") for m, r in res["field_mul"].items()]
    chains += [("K8", f"cios_loop {v}", r, "4 chains x 8") for v, r in res["cios_loop"].items()]
    chains += [("K10", f"mul_chain {m}", r, "one chain of 16") for m, r in res["mul_chain"].items()]
    for tag, what, r, shape in chains:
        extra = (f"; build alone {r['build_s']:.1f} s, {r['spill_stores']} B spill stores" if tag == "K8" else "")
        lines.append(f"[{tag}] {what}: {r['mul_mps']:.1f} M mul/s ({r['ms']:.4f} ms at {r['lanes']} lanes, {shape}); "
                     f"parity ok at {r['parity_lanes']} lanes; the {r['lanes']}-lane launch equal to plain "
                     f"({r['plain_ms']:.1f} ms); {r['registers']} registers, {r['local_bytes']} B local a thread, "
                     f"{r['smem_bytes']} B dynamic shared memory a block, {r['warps_per_sm']} warps a SM{extra}; {gpu}")
    return lines


def main() -> None:
    lb.device_of("cuda")
    gpu = gpu_line()
    res = run_all("cuda")
    for line in report_lines(res, gpu):
        print(line, flush=True)
    print(json.dumps(dict(gpu=gpu, **res)), flush=True)


if __name__ == "__main__":
    main()
