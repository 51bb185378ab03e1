"""The port's Groth16 slice against the JAX package, exactly.

  * NTT and coset transforms against the JAX ``get_ntt`` at 2^6 - 2^8;
  * on a toy R1CS built with ``circuit.r1cs``: A/B/C + H (``_abc_h_w``)
    against the JAX ``_abc_h_w_fn``, and whole proofs from the JAX setup's
    CRS (``convert.proving_key_from_jax``) byte-identical to the JAX
    ``groth16.prove`` under one ``FrRandom`` seed, accepted by both verifiers;
  * ``prepare_vote_context`` on the depth-2 election parses the same CRS as
    the JAX package, and its device point arrays equal JAX ``_devaff``'s;
  * every ``vote_saver_tpu_torch`` module, and chip_smoke.py, imports with
    ``jax``, ``jaxlib`` and the JAX package ``vote_saver_tpu`` blocked.

The full depth-2 vote is held to tests/golden/torch_slice_d2.json on the
card by chip_smoke.py (its MSM combination passes span 13k lanes, too slow
for the plain versions here).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vote_saver_tpu.circuit.r1cs import ConstraintSystem, lc
from vote_saver_tpu.ops import ntt as jntt
from vote_saver_tpu.params import R
from vote_saver_tpu.protocol import groth16 as jg
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.protocol import phases as jphases
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import ntt as tntt
from vote_saver_tpu_torch.protocol import groth16 as tg
from vote_saver_tpu_torch.protocol import phases as tphases
from vote_saver_tpu_torch.testing import torch_threads

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax(t):
    return jnp.asarray(convert.to_jax_limbs(t, 32))


def _back(a):
    return convert.from_jax_limbs(np.array(a))


@pytest.mark.parametrize("logn", [6, 7, 8])
def test_ntt_matches_jax(logn):
    n = 1 << logn
    rnd = np.random.default_rng(logn)
    vals = [[int(v) % R for v in rnd.integers(0, 2**62, size=n)] for _ in range(2)]
    vals[0][:3] = [0, 1, R - 1]
    x = lb.ints_to_tensor(vals, lb.FR)
    t, j = tntt.get_ntt(n), jntt.get_ntt(n)
    assert not j.use_mxu
    names = ("ntt", "intt", "coset_ntt", "coset_intt")
    # one jit of the four JAX transforms compiles faster than running them eagerly
    theirs = jax.jit(lambda v: tuple(getattr(j, name)(v) for name in names))(_jax(x))
    for name, exp in zip(names, theirs):
        assert torch.equal(getattr(t, name)(x), _back(exp)), name
    assert torch.equal(t.intt(t.ntt(x)), x)
    assert torch.equal(t.coset_intt(t.coset_ntt(x)), x)


def _toy_circuit(n=12):
    """out = prod (1 + x_i) over boolean x_i: 2n + 1 constraints, 1 public."""
    cs = ConstraintSystem()
    out = cs.alloc()
    cs.set_input_sizes(1)
    xs, ps = cs.alloc_vec(n), cs.alloc_vec(n)
    for x in xs:
        cs.constrain(lc((x, 1)), lc((x, 1)), lc((x, 1)))
    prev = 0
    for x, p in zip(xs, ps):
        cs.constrain(lc((prev, 1)), lc((x, 1), (0, 1)), lc((p, 1)))
        prev = p
    cs.constrain(lc((prev, 1)), lc((0, 1)), lc((out, 1)))

    def witness(bits):
        w = np.zeros((len(bits), cs.num_vars), dtype=object)
        w[:, 0] = 1
        for b, row in enumerate(bits):
            acc = 1
            for x, p, bit in zip(xs, ps, row):
                acc = acc * (bit + 1) % R
                w[b, x], w[b, p] = bit, acc
            w[b, out] = acc
        return w

    return cs, witness


@pytest.fixture(scope="module")
def toy():
    cs, witness = _toy_circuit()
    pk, vk = jg.setup(cs, FrRandom(5))
    w = witness([[1, 0] * 6, [1, 1, 0] * 4])
    assert cs.is_satisfied(w)
    return cs, pk, vk, w


def test_setup_matches_jax(toy):
    cs, pk, vk, _w = toy
    tpk, tvk = tg.setup(cs, FrRandom(5), device="host")
    assert M.ser_groth16_pk(tpk) == M.ser_groth16_pk(pk)
    assert M.ser_groth16_vk(tvk) == M.ser_groth16_vk(vk)


def test_abc_h_matches_jax(toy):
    _cs, pk, _vk, w = toy
    tpk = convert.proving_key_from_jax(pk)
    w_mont = tg.fr_ops().to_mont(lb.ints_to_tensor(w, lb.FR, mont=False))
    h, w_std, sat = tg._abc_h_w(tpk, w_mont)
    jh, jw, jsat = jg._abc_h_w_fn(pk)(_jax(w_mont))
    assert torch.equal(h, _back(jh)) and torch.equal(w_std, _back(jw))
    assert sat.tolist() == np.asarray(jsat).tolist() == [True, True]
    bad = w_mont.clone()
    bad[1, 1] = w_mont[0, 1] if not torch.equal(w_mont[0, 1], w_mont[1, 1]) else w_mont[1, 2]
    assert tg._abc_h_w(tpk, bad)[2].tolist() == [True, False]


def test_prove_byte_identical_to_jax(toy):
    _cs, pk, vk, w = toy
    jproofs = jg.prove(pk, w, FrRandom(9))
    tproofs = tg.prove(convert.proving_key_from_jax(pk), w, FrRandom(9), "cpu", window_bits=4)
    assert [M.ser_proof(p) for p in tproofs] == [M.ser_proof(p) for p in jproofs]
    tvk = convert.verification_key_from_jax(vk)
    for i, p in enumerate(tproofs):
        primary = [int(v) for v in w[i, 1:2]]
        assert jg.verify(vk, primary, p) and tg.verify(tvk, primary, p)
    assert not tg.verify(tvk, [int(w[0, 1]) + 1], tproofs[0])


def test_vote_context_matches_jax(election):
    e = election
    args = (2, 64, e["tree"], e["rt"], e["eid"], e["pk_eid"], e["pk_crs"], e["vk_crs"])
    ctx = tphases.prepare_vote_context(*args, device="cpu")
    jctx = jphases.prepare_vote_context(*args)
    assert ctx.eid == jctx.eid and ctx.eid_field == jctx.eid_field
    assert all(np.array_equal(a, b) for a, b in zip(ctx.levels, jctx.levels))
    assert M.ser_groth16_pk(ctx.pk) == e["pk_crs"] and M.ser_groth16_vk(ctx.vk) == e["vk_crs"]
    assert M.ser_saver_pk(ctx.spk) == e["pk_eid"]
    for name in ("a", "b1", "b2", "l", "h"):
        assert getattr(ctx.pk, f"{name}_pts") == getattr(jctx.pk, f"{name}_pts"), name
        ours = tg.devaff(ctx.pk, name, "cpu")
        theirs = jg._devaff(jctx.pk, name)
        for a, b in zip(ours, theirs):
            assert torch.equal(a, _back(b)), name
    for k in ("a", "b", "c"):
        assert all(np.array_equal(x, y) for x, y in zip(ctx.pk.coo[k], jctx.pk.coo[k]))
    b = e["ballots"][0]
    assert tphases.verify_ballot(b[0], b[1], b[2], e["vk_eid"], e["vk_crs"])


_BLOCKER = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "vote_saver_tpu")
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, NoJax())
"""

_IMPORT_CHECK = _BLOCKER + """
import vote_saver_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert {"vote_saver_tpu_torch.parallel.sharded", "vote_saver_tpu_torch.entry",
        "vote_saver_tpu_torch.run_election"} <= set(names)
for name in names:
    importlib.import_module(name)
import vote_saver_tpu_torch.convert
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print(len(names))
"""

_SMOKE_IMPORT_CHECK = _BLOCKER + """
import chip_smoke
assert callable(chip_smoke.main)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ok")
"""


def test_port_imports_without_jax():
    """Every module of the port imports with jax, jaxlib and the JAX
    package (the top-level name ``vote_saver_tpu``) blocked, the
    multi-rank layer, the dry run and the chain election among them.  (A
    spawned rank's sys.modules is checked in ``test_torch_sharded.py``.)"""
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py imports as a module (``main`` not run) with the same
    names blocked."""
    out = subprocess.run([sys.executable, "-c", _SMOKE_IMPORT_CHECK], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
