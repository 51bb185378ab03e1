"""The plain versions of K1's multiplier modes against the JAX package.

Every mode computes the same canonical a * b * R^-1 mod N.  The port's
``fold`` plan must be the JAX ``fold_mul.plan`` (geometry and matrix), and
its plain fold, the plain ``v1`` and the plain ``loop`` K1 must equal the
JAX ``fold_mul.mul_fold_spec`` and the Pallas emitter ``FqEmit.mul`` (run
eagerly on CPU in the 16-bit layout, through the ``env16`` fixture), in Fq
and Fr, special values included (0, 1, N - 1, R mod N as limbs).  Exact
equality throughout.  The CUDA instances are held to these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import random

import numpy as np
import pytest
import torch

from test_torch_curve import env16  # noqa: F401
from vote_saver_tpu_torch.ops import fold_mul
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _values(name: str, n: int, seed: int):
    """Raw limb values (the Montgomery product of x and y is x y R^-1):
    special values first, then random."""
    spec = lb.spec_for(name)
    N = spec.modulus
    rnd = random.Random(seed)
    xs = [0, 1, N - 1, spec.mont_r % N, N - 1, 1] + [rnd.randrange(N) for _ in range(n - 6)]
    ys = [N - 1, 1, N - 1, spec.mont_r % N, 0, N - 1] + [rnd.randrange(N) for _ in range(n - 6)]
    return spec, xs, ys


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_fold_plan_matches_jax(name):
    from vote_saver_tpu.ops import fold_mul as jfm
    from vote_saver_tpu.params import FieldSpec

    spec = lb.spec_for(name)
    p = fold_mul.plan(spec)
    jp = jfm.plan(FieldSpec(name, spec.modulus, 16, 2 * spec.num_limbs))
    assert np.array_equal(p["mat"], jp["mat"])
    for k in ("L", "lb", "nd", "ncols", "npieces", "nbytes", "n_limbs"):
        assert p[k] == jp[k], k
    assert p["n0_inv"] == int(jp["n0_inv"])
    assert (p["nd"], p["ncols"], p["mat"].shape) == ((48, 95, (285, 52)) if name == "fq" else (32, 63, (189, 36)))
    # the CUDA fold's packed layout holds the same matrix, four rows a word
    words = fold_mul.packed_matrix(spec).view(np.uint32)
    rows = np.stack([(words >> (8 * k)) & 255 for k in range(4)], axis=1).astype(np.uint8).view(np.int8)
    assert np.array_equal(rows.reshape(-1, p["nbytes"])[: p["mat"].shape[0]], p["mat"])
    assert not rows.reshape(-1, p["nbytes"])[p["mat"].shape[0]:].any()


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_plain_modes_match_jax_fold_and_emitter(env16, name):  # noqa: F811
    import jax.numpy as jnp
    import vote_saver_tpu.ops.fold_mul as jfm

    spec, xs, ys = _values(name, 24, 71 + (name == "fr"))
    N = spec.modulus
    a, b = lb.ints_to_tensor(xs, spec, mont=False), lb.ints_to_tensor(ys, spec, mont=False)
    want = [x * y * pow(spec.mont_r, -1, N) % N for x, y in zip(xs, ys)]
    loop = hf.mont_mul_plain(name, a, b, "loop")
    assert list(lb.tensor_to_ints(loop, spec, mont=False)) == want
    for mode in ("v1", "fold"):
        assert torch.equal(hf.mont_mul_plain(name, a, b, mode), loop), mode
        assert torch.equal(hf.mont_mul(name, a, b, mode), loop), mode  # a CPU tensor takes the plain version
    spec16 = env16["params"].fq_spec() if name == "fq" else env16["params"].fr_spec()
    a16 = np.array([spec16.to_limbs(x) for x in xs], np.uint32)
    b16 = np.array([spec16.to_limbs(y) for y in ys], np.uint32)
    jfold = np.asarray(jfm.mul_fold_spec(spec16, jnp.asarray(a16), jnp.asarray(b16)))
    assert [spec16.from_limbs(r) for r in jfold] == want
    emit = env16["pf"].FqEmit(spec16)  # the unrolled v1 emitter
    jv1 = np.asarray(emit.mul(jnp.asarray(a16.T), jnp.asarray(b16.T))).T
    assert [spec16.from_limbs(r) for r in jv1] == want


def test_mont_mul_rejects_an_unknown_mode():
    a = lb.ints_to_tensor([3], lb.FQ)
    with pytest.raises(ValueError):
        hf.mont_mul("fq", a, a, "fast")
    with pytest.raises(ValueError):
        hf.mont_mul_plain("fq", a, a, "fast")
