"""The multiply probes K7 and K8 against the JAX probes, on the CPU.

K8: ``scripts/micro_cios_loop.py``'s ``make_call("loop")`` and
``make_call("v1")`` run on one (24, 1, 128) tile of the 16-bit layout at
unroll 2 (the script reads ``MNT``, ``MS`` and ``sys.argv[1]`` when it is
imported): loop in interpret mode; v1's kernel, the same closure, op by op
with a stand-in for ``pl.pallas_call`` that hands it its whole arrays as
refs (its interpret-mode lowering unrolls the 576 products of every
multiply: the call did not end within ten minutes at unroll 2, and XLA's
compile of it held 18 GB of host memory at unroll 1).  The port's plain version of the probe
(``micro.mul_chain_plain`` with K8's starts, a 16k-bit rotation of the
lane's own element) must equal both outputs limb for limb after
``convert``'s repacking.  K7's body sits inside ``bench.bench_field_mul``
and cannot be called alone: its plain version is held to a host oracle
written from ``bench.py:288-291`` (chain k starts k lanes along the lane's
own row of 128), on two full rows and a short last row, which rolls within
its own lanes.  Chain starts of K8 lie in [Q, 2^384): every form must still
return the canonical product, the plain version and the CUDA forms alike.
The CUDA forms (field.cuh's mul, MulV1, and the carry chains of
``csrc/mul_ptx.cuh``) are compiled with g++ against that header's host
model of the PTX carry instructions.  Integer arithmetic: tolerance zero.
"""

import importlib.util
import pathlib
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vote_saver_tpu_torch import convert, micro
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.params import Q
from vote_saver_tpu_torch.testing import torch_threads

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "vote_saver_tpu_torch" / "csrc"
RINV = pow(1 << 384, -1, Q)
TOP = (1 << 384) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _lanes(n: int, seed: int) -> torch.Tensor:
    """n canonical Fq elements as (n, 12) int32 limbs, from numpy: random
    limbs with the top one cut below Q's, lanes 0-2 set to Q - 1, 1 and a
    value whose 16-bit rotations have every limb 0xFFFF but one."""
    g = np.random.default_rng(seed)
    x = g.integers(0, 1 << 32, (n, 12), dtype=np.uint64).astype(np.uint32)
    x[:, -1] &= np.uint32((1 << ((Q >> 352).bit_length() - 1)) - 1)
    t = lb.to_tensor(x)
    t[:3] = lb.ints_to_tensor([Q - 1, 1, (1 << 368) - 1], lb.FQ, mont=False)
    return t


def _ints(t: torch.Tensor) -> list[int]:
    return list(lb.tensor_to_ints(t, lb.FQ, mont=False))


@pytest.fixture(scope="module")
def k8_script():
    """scripts/micro_cios_loop.py at unroll 2 on one (24, 1, 128) tile, its
    JAX package fresh under the 16-bit limb layout; the JAX settings its
    import changes (bench._enable_compile_cache), the modules and the
    environment are put back afterwards."""
    import jax

    cache = {k: getattr(jax.config, k)
             for k in ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    mods = [m for m in sys.modules if m == "bench" or (m.startswith("vote_saver_tpu") and
                                                         not m.startswith("vote_saver_tpu_torch"))]
    saved = {m: sys.modules.pop(m) for m in mods}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTPU_LIMB_BITS", "16")
        mp.setenv("MNT", "1")
        mp.setenv("MS", "1")
        mp.setattr(sys, "argv", ["micro_cios_loop.py", "2"])
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location("micro_cios_loop", REPO / "scripts" / "micro_cios_loop.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert (mod.L, mod.S, mod.T, mod.NTILES, mod.UNROLL) == (24, 1, 128, 1, 2)
        yield mod
    for m in [m for m in sys.modules if m == "bench" or (m.startswith("vote_saver_tpu") and
                                                           not m.startswith("vote_saver_tpu_torch"))]:
        sys.modules.pop(m)
    sys.modules.update(saved)
    for k, v in cache.items():
        jax.config.update(k, v)


class _Ref:
    """A kernel ref over a whole array: ``ref[:]`` reads, ``ref[:] = v`` writes."""

    def __init__(self, v):
        self.v = v

    def __getitem__(self, idx):
        return self.v[idx]

    def __setitem__(self, idx, val):
        self.v = self.v.at[idx].set(val)


def _eager_pallas_call(kernel, grid, in_specs, out_specs, out_shape, interpret):
    """pl.pallas_call for a grid of one block that covers every array: the
    kernel runs once, op by op, on refs of the inputs and of zeroed outputs."""
    import jax.numpy as jnp

    assert grid == (1,)

    def call(*args):
        refs = [_Ref(jnp.asarray(a)) for a in args] + [_Ref(jnp.zeros(o.shape, o.dtype)) for o in out_shape]
        kernel(*refs)
        return tuple(r.v for r in refs[len(args):])

    return call


@pytest.mark.parametrize("variant,how", [("loop", "interpret"), ("v1", "eager")])
def test_k8_plain_equals_the_jax_probe(k8_script, monkeypatch, variant, how):
    if how == "eager":
        monkeypatch.setattr(k8_script, "pl", types.SimpleNamespace(pallas_call=_eager_pallas_call,
                                                                    BlockSpec=k8_script.pl.BlockSpec))
    else:
        assert k8_script.pf._interpret()
    x, y = _lanes(128, 8), _lanes(128, 9)
    tile = lambda t: convert.to_jax_limbs(t, 16).T.reshape(24, 1, 128)
    out0, out1 = k8_script.make_call(variant)(tile(x), tile(y))
    back = lambda o: convert.from_jax_limbs(np.asarray(o).reshape(24, 128).T)
    p0, p1 = micro.mul_chain_plain(variant, 4, 2, x, y, start="limbs")
    assert torch.equal(back(out0), p0)
    assert torch.equal(back(out1), p1)
    # the starts of chains 1.. are mostly >= Q, and the JAX sum is canonical
    starts = micro.chain_starts("limbs", 4, x)[1:]
    assert sum(v >= Q for s in starts for v in _ints(s)) > 300
    assert max(_ints(p1)) < Q


def _k7_oracle(xs, ys, unroll, chains=4):
    """bench.py:288-291 on host integers: the chains of a (rows, 128) tile
    are the tile rolled along its last axis by k; a short last row rolls
    within its own lanes.  -> (chain 0, field sum of chains 1..) a lane."""
    n, full = len(xs), len(xs) // 128 * 128
    grid = np.array(xs[:full], dtype=object).reshape(-1, 128)
    rolled = [np.concatenate([grid[..., k:], grid[..., :k]], axis=-1).reshape(-1).tolist() for k in range(chains)]
    tail = xs[full:]
    for k in range(chains):
        rolled[k] += [tail[(t + k) % len(tail)] for t in range(len(tail))]
    step = [pow(y * RINV % Q, unroll, Q) for y in ys]
    out0 = [rolled[0][i] * step[i] % Q for i in range(n)]
    out1 = [sum(rolled[k][i] for k in range(1, chains)) * step[i] % Q for i in range(n)]
    return out0, out1


@pytest.mark.parametrize("mode", hf.MODES)
def test_k7_plain_equals_the_row_roll_oracle(mode):
    n = 2 * 128 + 37
    x, y = _lanes(n, 7), _lanes(n, 17)
    want0, want1 = _k7_oracle(_ints(x), _ints(y), 6)
    p0, p1 = micro.mul_chain_plain(mode, 4, 6, x, y, start="rows")
    got0, got1 = _ints(p0), _ints(p1)
    assert got0 == want0
    assert got1 == want1
    # lanes 125-127 of a row take chains from its first lanes, not from the
    # next row's (the indexing x[(i + k) % n] that the probes had before)
    xs, ys = _ints(x), _ints(y)
    old = [sum(xs[(i + k) % n] for k in (1, 2, 3)) * pow(ys[i] * RINV % Q, 6, Q) % Q for i in range(n)]
    assert [got1[i] == old[i] for i in range(128)] == [True] * 125 + [False] * 3


def _above_q(n: int, seed: int) -> list[int]:
    """n values in [Q, 2^384): the extremes, K8's rotations of canonical
    elements, and random ones."""
    rnd = random.Random(seed)
    rot = lambda v, k: ((v >> (16 * k)) | (v << (384 - 16 * k))) & TOP
    vals = [Q, TOP, TOP - 1, 2 * Q, 8 * Q + 5, (1 << 383) | 1]
    while len(vals) < n:
        v = rot(rnd.randrange(Q), rnd.randrange(1, 24)) if len(vals) % 2 else rnd.randrange(Q, 1 << 384)
        if v >= Q:
            vals.append(v)
    return vals


def test_plain_multiply_is_canonical_from_starts_at_or_above_q():
    a = _above_q(64, 3)
    b = [Q - 1, 0, 1] + [random.Random(4).randrange(Q) for _ in range(61)]
    ta, tb = (lb.ints_to_tensor(v, lb.FQ, mont=False) for v in (a, b))
    want = [u * v * RINV % Q for u, v in zip(a, b)]
    for mode in ("loop", "v1"):
        assert _ints(hf.mont_mul_plain("fq", ta, tb, mode)) == want
    # and the K8 chains, whose starts are such values
    x, y = lb.ints_to_tensor(a[:16], lb.FQ, mont=False), tb[:16]
    _p0, p1 = micro.mul_chain_plain("loop", 4, 8, x, y, start="limbs")
    assert max(_ints(p1)) < Q


_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __ldg(p) (*(p))
#include "field.cuh"
#include "mul_modes.cuh"
#include "mul_ptx.cuh"

template <class M>
void put(const Fq& a, const Fq& b) {
  const Fq r = M::template mul<FqParams>(a, b);
  for (int j = 0; j < 12; ++j) printf("%u ", r.v[j]);
  printf("\n");
}

int main() {
  Fq a, b;
  for (;;) {
    for (int j = 0; j < 12; ++j)
      if (scanf("%u", &a.v[j]) != 1) return 0;
    for (int j = 0; j < 12; ++j)
      if (scanf("%u", &b.v[j]) != 1) return 0;
    put<MulLoop>(a, b);
    put<MulV1>(a, b);
    put<MulLoopPtx>(a, b);
    put<MulV1Ptx>(a, b);
  }
}
"""
# the parts of cuda_runtime.h that mul_modes.cuh's host code names
_RUNTIME = """#pragma once
#include <cstddef>
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
template <class T>
int cudaMemcpyToSymbol(T&, const void*, size_t) { return 0; }
"""
FORMS = ("MulLoop", "MulV1", "MulLoopPtx", "MulV1Ptx")


@pytest.fixture(scope="module")
def host_forms(tmp_path_factory):
    """The CUDA multiply forms built with g++ on the headers' host model."""
    d = tmp_path_factory.mktemp("mul_host")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Wno-unknown-pragmas", "-Werror", f"-I{d}", f"-I{CSRC}",
                    "-o", str(exe), str(d / "harness.cpp")], check=True, capture_output=True, text=True, timeout=120)

    def run(pairs):
        limbs = lambda v: " ".join(str((v >> (32 * j)) & 0xFFFFFFFF) for j in range(12))
        out = subprocess.run([str(exe)], input="\n".join(f"{limbs(a)} {limbs(b)}" for a, b in pairs),
                             capture_output=True, text=True, check=True, timeout=120).stdout.split("\n")
        word = lambda line: sum(int(w) << (32 * j) for j, w in enumerate(line.split()))
        return {f: [word(out[len(FORMS) * i + k]) for i in range(len(pairs))] for k, f in enumerate(FORMS)}

    return run


def test_cuda_forms_are_canonical_from_starts_at_or_above_q(host_forms):
    """a in [Q, 2^384) (K8's starts, the extremes) and canonical a, b < Q
    with its extremes: every form returns a b R^-1 mod Q, below Q."""
    rnd = random.Random(5)
    a = _above_q(400, 6) + [rnd.randrange(Q) for _ in range(300)] + [0, 1, Q - 1]
    b = [rnd.choice([0, 1, Q - 1, rnd.randrange(Q)]) if i % 7 == 0 else rnd.randrange(Q) for i in range(len(a))]
    got = host_forms(list(zip(a, b)))
    want = [u * v * RINV % Q for u, v in zip(a, b)]
    for form in FORMS:
        assert got[form] == want, form


def test_cuda_forms_equal_the_plain_version(host_forms):
    """The same forms against the plain multiply on K8's chain starts."""
    x, y = _lanes(96, 12), _lanes(96, 13)
    starts = micro.chain_starts("limbs", 4, x)
    for s in starts:
        got = host_forms(list(zip(_ints(s), _ints(y))))
        want = _ints(hf.mont_mul_plain("fq", s, y, "loop"))
        for form in FORMS:
            assert got[form] == want, form
