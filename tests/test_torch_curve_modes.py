"""The curve kernels K2-K6, K3d and K1's Fermat chain in every multiplier mode.

The JAX package compiles each curve kernel with the emitter that
``VSTPU_MUL`` names (``pallas_field._make_emit``): ``FqEmitLoop`` (loop),
``FqEmit`` (v1) or ``FqEmitFold`` (fold, its matrix bound as
``_fold_inputs`` binds it), each wrapped in ``Fq2Emit`` for G2.  Here the
formulas ``_jac_madd``, ``_jac_add`` (complete and distinct),
``_jac_double`` and ``_jac_addx`` run eagerly on the CPU in the 16-bit
layout through each emitter (its products kept for the next formula of
the same lanes; the loop and fold emitters' multiply and square compiled
once), on testing.special_lanes' 8 lanes, and must equal the port's
wrapper called with that ``mode=`` on CPU tensors (its
plain version, one function in every mode) limb for limb after
``convert.from_jax_limbs``.  Also: ``mont_inv`` in each mode against
Python's ``pow``, ``hopper_field.mul_mode`` against ``pallas_field._mul_mode``
under ``VSTPU_MUL``, and every (kernel, mode) instance present in
``KERNELS``, ``REPLACES``, ``SOURCES`` and the build's units.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _from_jax, _jax_cols, _port, env16  # noqa: F401
from vote_saver_tpu_torch.ops import _build
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import ADDX_EXC, MADD_EXC, special_lanes, torch_threads

LANES = 8
FORMULAS = ("madd", "add", "add_distinct", "double", "addx")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


class _Emitter:
    """A JAX emitter whose multiply and square keep each result they have
    computed, keyed by their operands' limbs: the complete add, the distinct
    add and the flagged add of one seed's lanes share the generic formula's
    products, and the complete add's doubling branch is _jac_double's.  The
    loop and fold emitters' multiply and square run as one compiled call
    each (jax.jit): FqEmitLoop's lax.fori_loop, run eagerly, would trace and
    compile its body at every multiply, and FqEmitFold's 2,304 digit FMAs
    cost 50 ms a multiply run op by op.  FqEmit's unrolled multiply (v1)
    runs eagerly: XLA takes minutes to compile it.  Every other operation
    is the emitter's own."""

    def __init__(self, e, compiled: bool):
        self._e = e
        self._ops = {k: jax.jit(getattr(e, k)) if compiled else getattr(e, k) for k in ("mul", "sq")}
        self._seen: dict = {}

    def _run(self, op, *args):
        key = (op,) + tuple(np.asarray(a).tobytes() for a in args)
        if key not in self._seen:
            self._seen[key] = self._ops[op](*args)
        return self._seen[key]

    def mul(self, a, b):
        return self._run("mul", a, b)

    def sq(self, a):
        return self._run("sq", a)

    def __getattr__(self, name):
        return getattr(self._e, name)


_EMITTERS: dict = {}


def _emitter(env, mode: str, g2: bool):
    """The emitter the JAX package's kernel body runs in `mode`, the fold
    matrix bound as _fold_inputs binds it (its (nbytes, rows) bf16 value);
    one per module copy and mode, so each compiles once."""
    pf = env["pf"]
    key = (id(pf), mode)
    if key not in _EMITTERS:
        e = pf._make_emit(env["params"].fq_spec(), mode)
        extras, _specs, bind = pf._fold_inputs(e)
        if extras:
            bind(extras[0])
        _EMITTERS[key] = _Emitter(e, compiled=mode != "v1")
    e = _EMITTERS[key]
    return pf.Fq2Emit(e) if g2 else e


def _jax_formula(env, mode, g2, formula, lanes):
    p, q, acc, qm, sign, active = lanes
    f = _emitter(env, mode, g2)
    pf = env["pf"]
    P, Qc = _jax_cols(p, 3, g2, env), _jax_cols(q, 3, g2, env)
    if formula == "madd":
        out, exc = pf._jac_madd(f, _jax_cols(acc, 3, g2, env), _jax_cols(qm, 2, g2, env), jnp.asarray(sign),
                                jnp.asarray(active))
    elif formula == "addx":
        out, exc = pf._jac_addx(f, P, Qc)
    elif formula == "double":
        out, exc = pf._jac_double(f, P), None
    else:
        out, exc = pf._jac_add(f, P, Qc, complete=formula == "add"), None
    return tuple(_from_jax(c, g2) for c in out), (None if exc is None else [int(bool(x)) for x in np.asarray(exc)])


def _port_formula(mode, g2, formula, lanes):
    p, q, acc, qm, sign, active = lanes
    pre = "g2" if g2 else "g1"
    fn = getattr(hf, f"{pre}_{formula}")
    P, Qc = _port(p, 3), _port(q, 3)
    if formula == "madd":
        out, exc = fn(_port(acc, 3), _port(qm, 2), torch.tensor(sign), torch.tensor(active), mode=mode)
    elif formula == "addx":
        out, exc = fn(P, Qc, mode=mode)
    elif formula == "double":
        out, exc = fn(P, mode=mode), None
    else:
        out, exc = fn(P, Qc, mode=mode), None
    return out, (None if exc is None else exc.tolist())


@pytest.mark.parametrize("formula", FORMULAS)
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("mode", hf.MODES)
def test_curve_formula_in_each_mode_matches_pallas(env16, mode, g2, formula):
    # one seed a group: the formulas' shared products are computed once
    lanes = special_lanes(g2, LANES, random.Random(41 + g2))
    jout, jexc = _jax_formula(env16, mode, g2, formula, lanes)
    out, exc = _port_formula(mode, g2, formula, lanes)
    for got, exp in zip(out, jout):
        assert torch.equal(got, exp)
    assert exc == jexc
    if formula in ("madd", "addx"):
        assert exc == (MADD_EXC if formula == "madd" else ADDX_EXC)


@pytest.mark.parametrize("mode", hf.MODES)
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_mont_inv_in_each_mode(mode, name):
    spec = lb.spec_for(name)
    N = spec.modulus
    rnd = random.Random(43)
    xs = [1, N - 1, spec.mont_r % N] + [rnd.randrange(1, N) for _ in range(LANES - 3)]
    got = hf.mont_inv(name, lb.ints_to_tensor(xs, spec), mode=mode)
    assert list(lb.tensor_to_ints(got, spec)) == [pow(x, N - 2, N) for x in xs]


@pytest.mark.parametrize("value", [None, "loop", "v1", "fold", "karatsuba"])
def test_mul_mode_follows_vstpu_mul(env16, monkeypatch, value):
    """The port reads VSTPU_MUL at each call, as the JAX package does; a
    value that names no mode raises in the port (the JAX package would
    compile its loop emitter for it)."""
    if value is None:
        monkeypatch.delenv("VSTPU_MUL", raising=False)
    else:
        monkeypatch.setenv("VSTPU_MUL", value)
    want = env16["pf"]._mul_mode()
    if want in hf.MODES:
        assert hf.mul_mode() == want
        p, q, *_ = special_lanes(False, LANES, random.Random(44))
        assert all(torch.equal(a, b) for a, b in zip(hf.g1_add(_port(p, 3), _port(q, 3)),
                                                     hf.add_plain(False, _port(p, 3), _port(q, 3))))
    else:
        assert want == value
        with pytest.raises(ValueError):
            hf.mul_mode()
        with pytest.raises(ValueError):
            hf.mont_inv("fr", lb.ints_to_tensor([1], lb.FR))


@pytest.mark.parametrize("mode", hf.MODES)
@pytest.mark.parametrize("kernel", hf.CURVE_KERNELS)
def test_every_instance_is_listed_and_built(kernel, mode):
    """Each (kernel, mode) instance has its name, the pallas_call it
    replaces (its loop instance's), the csrc/ unit it is built from, and
    its launcher in that unit's build entry."""
    name = hf.instance(kernel, mode)
    assert name in hf.KERNELS and hf.launches[name] == 0 and hf.mode_of(name) == mode
    assert hf.REPLACES[name] == hf.REPLACES[kernel] and hf.REPLACES[name].startswith("vote_saver_tpu/ops/")
    unit = hf.SOURCES[name].rsplit("/", 1)[1]
    assert unit in _build.UNITS and (_build.CSRC / unit).exists()
    if mode != "loop":
        assert unit == f"curve_{mode}.cu"
    launcher = {"mont_inv": "vs_mont_inv", "madd_scan": "vs_madd_scan", "madd": "vs_madd",
                "add_shift": "vs_add_shift", "add_distinct": "vs_add_distinct", "double": "vs_double",
                "addx": "vs_addx", "window_sum": "vs_window_sum"}.get(kernel[3:] if kernel[:2] in ("g1", "g2") else kernel[:8])
    if kernel == "g1_add":
        launcher = "vs_g1_add"
    elif kernel == "g2_add":
        launcher = "vs_g2_add_team"
    assert (launcher if mode == "loop" else f"{launcher}_{mode}") in _build.UNITS[unit]
    if mode == "fold":
        assert "vs_curve_fold_upload" in _build.UNITS[unit]
