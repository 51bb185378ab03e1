"""The port's int8 matmul NTT (``vote_saver_tpu_torch/ops/ntt_mxu.py``)
against the JAX package's ``ops/ntt_mxu.py`` and the port's radix-2 path,
limb for limb after ``convert.py``'s repack.

  * each of the four kinds at n = 256 (n1 = n2 = 16) on the JAX test's
    inputs (random values and a block that saturates digit columns and fold
    boundaries), and one kind at n = 2^9 (n1 = 16, n2 = 32), in both
    product forms (``impl="int8"``: ``torch._int_mm``; ``"int64"``: an
    int64 matmul);
  * the fold matrix byte for byte, the mod-r fold on random and extreme
    digit columns, and the Toeplitz product's int32 columns against the JAX
    digit convolution before the fold;
  * ``groth16._abc_h_w`` on the depth-2 election (2^14 domain, B = 2): the
    same h through ``ntt="matmul"`` and ``ntt="radix2"``;
  * the dispatch: CPU tensors take radix-2 by default, an explicit path is
    honoured, an unknown one raises, and the card's rule is 2^12.

The JAX rig runs 32-bit limbs (``tests/conftest.py``), the port's layout,
so the JAX fold matrix is ``_fold_matrix(73, 32)`` as the port's.
"""

import json
import pathlib
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vote_saver_tpu.ops import ntt_mxu as jmxu
from vote_saver_tpu.params import fr_spec
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.circuit.r1cs import ConstraintSystem, lc
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import merkle
from vote_saver_tpu_torch.ops import ntt as tntt
from vote_saver_tpu_torch.ops import ntt_mxu
from vote_saver_tpu_torch.ops.field_ops import fr_ops
from vote_saver_tpu_torch.params import R, SECRET_KEY_BITS
from vote_saver_tpu_torch.protocol import groth16, phases
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.testing import torch_threads

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = [("fwd", "ntt"), ("inv", "intt"), ("fwd_coset", "coset_ntt"), ("inv_coset", "coset_intt")]
IMPLS = ["int8", "int64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax(t):
    return jnp.asarray(convert.to_jax_limbs(t, 32))


def _back(a):
    return convert.from_jax_limbs(np.asarray(a))


def _inputs(n: int) -> torch.Tensor:
    """tests/test_ntt_mxu.py's inputs at n: two rows of random values, the
    first row led by a block that saturates digit columns and fold
    boundaries, the second by four R - 1."""
    rng = random.Random(0xA17)
    vals = [rng.randrange(R) for _ in range(2 * n)]
    vals[:8] = [0, 1, R - 1, R - 2, (1 << 254) - 1, R - (1 << 200), 2, R // 2]
    vals[n : n + 4] = [R - 1] * 4
    return lb.ints_to_tensor(np.array(vals, dtype=object).reshape(2, n), lb.FR)


_jax_results: dict = {}


def _jax_apply(n: int, kind: str) -> torch.Tensor:
    """The JAX plan's transform of _inputs(n), computed once per module."""
    if (n, kind) not in _jax_results:
        _jax_results[n, kind] = _back(jmxu.get_plan(n, kind).apply(_jax(_inputs(n))))
    return _jax_results[n, kind]


def test_rig_runs_the_ports_limb_layout():
    assert fr_spec().limb_bits == ntt_mxu.LIMB_BITS == 32


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind,ref", KINDS)
def test_each_kind_matches_jax_and_radix2(kind, ref, impl):
    x = _inputs(256)
    got = ntt_mxu.get_plan(256, kind).apply(x, impl)
    assert torch.equal(got, _jax_apply(256, kind))
    assert torch.equal(got, getattr(tntt.get_ntt(256, "radix2"), ref)(x))
    if impl == "int8":  # the NTT's matmul path maps each transform to its plan
        assert torch.equal(getattr(tntt.get_ntt(256, "matmul"), ref)(x), got)


@pytest.mark.parametrize("impl", IMPLS)
def test_uneven_split_matches_jax_and_radix2(impl):
    n = 1 << 9
    plan = ntt_mxu.get_plan(n, "inv_coset")
    assert (plan.n1, plan.n2) == (16, 32)
    x = _inputs(n)
    got = plan.apply(x, impl)
    assert torch.equal(got, _jax_apply(n, "inv_coset"))
    assert torch.equal(got, tntt.get_ntt(n, "radix2").coset_intt(x))


def test_fold_matrix_is_the_jax_packages_with_headroom():
    f = ntt_mxu._fold_matrix(ntt_mxu.NCOLS, ntt_mxu.LIMB_BITS)
    assert f.dtype == np.int8 and f.shape == (365, 33)
    assert f.tobytes() == jmxu._fold_matrix(73, 32).tobytes()
    # every row is a valid balanced representation of 2^(7u + 32) mod r
    for u in range(73 * 5):
        kc, t = divmod(u, 5)
        v = sum(int(d) << (8 * i) for i, d in enumerate(f[u]))
        assert v == pow(2, 7 * (kc + t) + 32, R)


@pytest.mark.parametrize("impl", IMPLS)
def test_fold_mod_r_matches_jax(impl):
    rnd = np.random.default_rng(11)
    cols = rnd.integers(0, 1 << 31, size=(40, 73), dtype=np.int64)
    cols[0] = 0
    cols[1] = (1 << 31) - 1  # every 7-bit piece of every column saturated
    cols[2, ::2] = (1 << 31) - 1
    cols[3] = 127
    got = ntt_mxu._fold_mod_r(torch.from_numpy(cols.astype(np.int32)), impl)
    want = _back(jmxu._fold_mod_r(jnp.asarray(cols.astype(np.int32))))
    assert torch.equal(got, want)
    ints = lb.tensor_to_ints(got, lb.FR, mont=False)
    assert all(int(v) == sum(int(c) << (7 * k) for k, c in enumerate(row)) % R for v, row in zip(ints, cols))


@pytest.mark.parametrize("impl", IMPLS)
def test_toeplitz_product_columns_equal_the_jax_convolution(impl):
    n = 256
    plan, jplan = ntt_mxu.get_plan(n, "fwd_coset"), jmxu.get_plan(n, "fwd_coset")
    assert np.array_equal(plan.w1d, jplan.w1d[..., ::-1]) and np.array_equal(plan.w2td, jplan.w2td[..., ::-1])
    xa = _inputs(n).reshape(2, 16, 16, 8).transpose(1, 2).reshape(32, 16, 8)
    digits = ntt_mxu._digits7_device(xa)
    assert torch.equal(digits, torch.from_numpy(np.array(jmxu._digits7_device(_jax(xa)))))
    got = ntt_mxu._columns(plan.table("a", "cpu"), xa, impl, "step_a")
    want = jax.lax.conv_general_dilated(
        jmxu._digits7_device(_jax(xa)), jnp.asarray(jplan.w1d), window_strides=(1,),
        padding=[(36, 36)], dimension_numbers=("NCH", "OIH", "NCH"), preferred_element_type=jnp.int32,
    )
    assert got.shape == (32, 16, 73)
    assert torch.equal(got.to(torch.int64), torch.from_numpy(np.asarray(want).astype(np.int64)))


def test_abc_h_depth2_same_through_both_paths():
    golden = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    e = pickle.loads((ROOT / golden["source"]).read_bytes())
    ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"],
                                      e["pk_eid"], e["pk_crs"], e["vk_crs"], device="cpu")
    idx, votes = golden["voters"][:2], golden["votes"][:2]
    sks = [M.de_bitarray(e["voters"][i][1], SECRET_KEY_BITS) for i in idx]
    sib = np.stack([merkle.copath(ctx.levels, i) for i in idx]).astype(object)
    wit = ctx.circ.generate_witness(np.array(votes), np.array(ctx.eid, dtype=object), np.array(sks, dtype=object),
                                    np.array(idx), sib)
    w_mont = fr_ops().to_mont(lb.ints_to_tensor(wit.values, lb.FR, mont=False))
    assert ctx.pk.domain == 1 << 14
    with torch_threads(4):
        before = dict(ntt_mxu.products)
        hm, wm, satm = groth16._abc_h_w(ctx.pk, w_mont, ntt="matmul")
        assert {k: ntt_mxu.products[k] - before[k] for k in before} == {"step_a": 7, "step_c": 7, "fold": 14}
        hr, wr, satr = groth16._abc_h_w(ctx.pk, w_mont, ntt="radix2")
    assert satm.tolist() == satr.tolist() == [True, True]
    assert torch.equal(hm, hr) and torch.equal(wm, wr)


def _toy_pk():
    """A proving key with no CRS points over a 12-bit product circuit (25
    constraints, a 32-element domain): all ``_abc_h_w`` reads, and a
    satisfying Montgomery witness for two voters."""
    cs = ConstraintSystem()
    out = cs.alloc()
    cs.set_input_sizes(1)
    xs, ps = cs.alloc_vec(12), cs.alloc_vec(12)
    for x in xs:
        cs.constrain(lc((x, 1)), lc((x, 1)), lc((x, 1)))
    prev = 0
    for x, p in zip(xs, ps):
        cs.constrain(lc((prev, 1)), lc((x, 1), (0, 1)), lc((p, 1)))
        prev = p
    cs.constrain(lc((prev, 1)), lc((0, 1)), lc((out, 1)))
    w = np.zeros((2, cs.num_vars), dtype=object)
    w[:, 0] = 1
    for b, bits in enumerate(([1, 0] * 6, [1, 1, 0] * 4)):
        acc = 1
        for x, p, bit in zip(xs, ps, bits):
            acc = acc * (bit + 1) % R
            w[b, x], w[b, p] = bit, acc
        w[b, out] = acc
    assert cs.is_satisfied(w)
    pk = groth16.ProvingKey(
        num_primary=1, num_vars=cs.num_vars, domain=32, a_pts=[], b1_pts=[], b2_pts=[], h_pts=[], l_pts=[],
        alpha_g1=None, beta_g1=None, beta_g2=None, delta_g1=None, delta_g2=None, coo=cs.to_coo(),
        num_constraints=cs.num_constraints,
    )
    return pk, fr_ops().to_mont(lb.ints_to_tensor(w, lb.FR, mont=False))


def test_cpu_tensors_default_to_radix2():
    pk, w_mont = _toy_pk()
    before = dict(ntt_mxu.products)
    h, _w, sat = groth16._abc_h_w(pk, w_mont)
    assert ntt_mxu.products == before
    assert sat.tolist() == [True, True]
    assert torch.equal(h, groth16._abc_h_w(pk, w_mont, ntt="radix2")[0])


def test_explicit_matmul_path_is_honoured():
    pk, w_mont = _toy_pk()
    before = dict(ntt_mxu.products)
    h, _w, sat = groth16._abc_h_w(pk, w_mont, ntt="matmul")
    assert {k: ntt_mxu.products[k] - before[k] for k in before} == {"step_a": 7, "step_c": 7, "fold": 14}
    assert sat.tolist() == [True, True]
    assert torch.equal(h, groth16._abc_h_w(pk, w_mont, ntt="radix2")[0])


def test_unknown_path_or_impl_raises():
    pk, w_mont = _toy_pk()
    with pytest.raises(ValueError, match="unknown NTT path"):
        groth16._abc_h_w(pk, w_mont, ntt="mxu")
    with pytest.raises(ValueError, match="unknown NTT path"):
        tntt.NTT(256, "fft")
    with pytest.raises(ValueError, match="unknown product impl"):
        ntt_mxu.get_plan(256, "fwd").apply(_inputs(256), "float64")


def test_card_rule_takes_matmul_from_2_to_the_12():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tntt.choose_path(None, 1 << 12, cuda) == tntt.choose_path(None, 1 << 15, cuda) == "matmul"
    assert tntt.choose_path(None, 1 << 11, cuda) == "radix2"
    assert tntt.choose_path(None, 1 << 15, cpu) == "radix2"
    assert tntt.choose_path("radix2", 1 << 15, cuda) == "radix2"
    assert tntt.choose_path("matmul", 16, cpu) == "matmul"
