"""The fold mode's G1 bucket scan and G1 doubling with their fold product on
the int8 tensor cores (``csrc/curve_fold.cu``: ``Called<MulFoldMma>``), on
the CPU, against the JAX package.

On the card each Fq multiply of these two instances runs the tensor-core
fold of ``csrc/fold_mma.cuh``: a warp's 32 lanes of byte pieces as one A
tile against the fold matrix, the lanes past n of a ragged warp padding
rows.  Its data flow in plain PyTorch is ``fold_mul.mul_fold_tile``.  Here
the plain formulas ``hopper_field.jac_madd`` (every multiply on every lane,
then the selects: the converged kernel's ``jac_madd_select``),
``madd_scan_plain`` and ``double_plain`` run over an Fq whose multiply is
that tile model, at 16 lanes (half a tile) and at 2 x 32 + 7 (the last tile
ragged), on ``testing.special_lanes`` and ``testing.scan_lanes`` (idle
codes, (0, 0) points, acc at infinity, h = 0 with r != 0, the doubling
corner's flag).  They must equal the existing plain versions and, limb for
limb, the JAX package's ``_jac_madd`` / ``_jac_double`` through the fold
emitter (``FqEmitFold``, the body of ``_g1_madd_call`` / ``_g1_dbl_call``
under ``VSTPU_MUL=fold``), run as ``tests/test_torch_curve_modes.py`` runs
them (the JAX package unchanged), the scan row by row as
``msm_sched._msm_device`` runs it.  Also: chip_smoke.py's names and SASS
counts of the two instances, whose multiply is a called device function.
Exact equality throughout.

    python -m pytest tests/test_torch_fold_curve.py -q -p no:cacheprovider
"""

import contextlib
import pathlib
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curve import _from_jax, _jax_cols, _port, env16  # noqa: F401
from test_torch_curve_modes import _emitter
from vote_saver_tpu_torch.ops import _build, fold_mul
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.testing import MADD_EXC, SCAN_EXC, scan_lanes, special_lanes, torch_threads

# half a warp's tile (Horner's 16 lanes), and two tiles and a ragged one
LANES = (16, 2 * fold_mul.TILE_LANES + 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _root_on_path():
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)


class TileFq(hf.HalfField):
    """Fq whose multiply is the tensor-core fold's data flow: the lanes of
    the flattened batch in tiles of 32, each tile's pieces times the B
    operand (``fold_mul.mul_fold_tile``); every other operation HalfField's."""

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        L = lb.FQ.num_limbs
        out = fold_mul.mul_fold_tile(lb.FQ, hf._pack(a).reshape(-1, L), hf._pack(b).reshape(-1, L))
        return hf._half(out).reshape(a.shape)


@contextlib.contextmanager
def _tile_fq():
    """hopper_field's plain G1 formulas over TileFq while inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(hf.HALF, "fq", TileFq(lb.FQ))
        yield


def _jax_double(env, P_host, times: int):
    """``_jac_double`` through the fold emitter, `times` times."""
    f = _emitter(env, "fold", False)
    cols = _jax_cols(P_host, 3, False, env)
    for _ in range(times):
        cols = env["pf"]._jac_double(f, cols)
    return tuple(_from_jax(c, False) for c in cols)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("lanes", LANES)
def test_madd_on_the_tile_matches_the_fold_pallas_madd(env16, lanes):
    """The converged madd (all 11 multiplies on every lane, then the lift,
    the opposite-point infinity and the inactive keep, in that order) with
    the tile's multiply: the plain madd's limbs and flags, and the JAX fold
    formula's."""
    p, q, acc, qm, sign, active = special_lanes(False, lanes, random.Random(60 + lanes))
    A, QA, S, ACT = _port(acc, 3), _port(qm, 2), torch.tensor(sign), torch.tensor(active)
    want, wexc = hf.madd_plain(False, A, QA, S, ACT)
    with _tile_fq():
        out, exc = hf.jac_madd(hf._field(False), tuple(map(hf._half, A)), tuple(map(hf._half, QA)), S, ACT)
    got, exc = tuple(map(hf._pack, out)), exc.to(torch.int32)
    assert _equal(got, want) and torch.equal(exc, wexc)
    assert exc[: len(MADD_EXC)].tolist() == MADD_EXC
    f = _emitter(env16, "fold", False)
    jout, jexc = env16["pf"]._jac_madd(f, _jax_cols(acc, 3, False, env16), _jax_cols(qm, 2, False, env16),
                                       jnp.asarray(sign), jnp.asarray(active))
    assert _equal(got, tuple(_from_jax(c, False) for c in jout))
    assert exc.tolist() == [int(bool(x)) for x in np.asarray(jexc)]


@pytest.mark.parametrize("lanes", LANES)
def test_double_on_the_tile_matches_the_fold_pallas_double(env16, lanes):
    """Two doublings with the tile's multiply, canonical infinity (lane 0)
    and p = q's operands included: the plain doubling's limbs and the JAX
    fold formula's."""
    p, *_ = special_lanes(False, lanes, random.Random(70 + lanes))
    P = _port(p, 3)
    want = hf.double_plain(False, P, 2)
    with _tile_fq():
        got = hf.double_plain(False, P, 2)
    assert _equal(got, want)
    assert not got[2][0].any()
    assert _equal(got, _jax_double(env16, p, 2))


@pytest.mark.parametrize("lanes", LANES)
def test_scan_on_the_tile_matches_the_fold_pallas_row_scan(env16, lanes):
    """The bucket scan with the tile's multiply, as madd_scan_plain runs it
    (the live lanes of each row) and as the converged kernel runs it (every
    lane of every row through the select-form madd): the plain scan's limbs
    and flags, and the JAX row scan with the fold formula's, on idle codes,
    (0, 0) points, signs and the doubling corner."""
    steps = 6
    pts, codes = scan_lanes(False, 24, lanes, steps, random.Random(80 + lanes))
    pxy = ms.g1_affine_to_device(pts, "cpu")
    c = torch.from_numpy(codes)
    want, wexc = hf.madd_scan_plain(False, pxy, c)
    with _tile_fq():
        got, exc = hf.madd_scan_plain(False, pxy, c)
        f = hf._field(False)
        acc = tuple(map(hf._half, hf._infinity(False, (lanes,), "cpu")))
        kexc = torch.zeros(lanes, dtype=torch.bool)
        for row in c:
            pidx = ((row & ((1 << 30) - 1)) - 1).clamp(min=0)
            q = tuple(hf._half(t.index_select(0, pidx)) for t in pxy)
            acc, e = hf.jac_madd(f, acc, q, ((row >> 30) & 1) != 0, row != 0)
            kexc |= e
    assert _equal(got, want) and torch.equal(exc, wexc)
    assert _equal(tuple(map(hf._pack, acc)), want) and torch.equal(kexc.to(torch.int32), wexc)
    assert exc[: len(SCAN_EXC)].tolist() == SCAN_EXC
    one, zero = 1, 0
    table = [(zero, zero) if pt is None else pt for pt in pts]
    fj = _emitter(env16, "fold", False)
    jacc = _jax_cols([(one, one, zero)] * lanes, 3, False, env16)
    jexc = np.zeros(lanes, bool)
    for row in codes:
        pidx = np.maximum((row & ((1 << 30) - 1)) - 1, 0)
        q = _jax_cols([table[k] for k in pidx], 2, False, env16)
        jacc, e = env16["pf"]._jac_madd(fj, jacc, q, jnp.asarray(((row >> 30) & 1).astype(bool)),
                                        jnp.asarray(row != 0))
        jexc |= np.asarray(e).astype(bool)
    assert _equal(got, tuple(_from_jax(t, False) for t in jacc))
    assert exc.tolist() == jexc.astype(int).tolist()


# the fold unit's tensor-core instances as the profiler (demangled) and
# ptxas / cuobjdump (mangled) name them, called and inlined, and a G2 fold
# instance beside them
_NAMES = {
    "(anonymous namespace)::k_madd_scan<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)":
        "g1_madd_scan_fold",
    "(anonymous namespace)::k_double<Fp<FqParams>, Called<MulFoldMma> >(unsigned int const*, ...)": "g1_double_fold",
    "(anonymous namespace)::k_double<Fp<FqParams>, MulFoldMma>(unsigned int const*, ...)": "g1_double_fold",
    "(anonymous namespace)::k_double<Fq2, MulFold>(unsigned int const*, ...)": "g2_double_fold",
    "(anonymous namespace)::k_madd_scan<Fq2, MulFold>(unsigned int const*, ...)": "g2_madd_scan_fold",
}
_SCAN = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN11k_madd_scanI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_PKiixPjSC_SC_Pi"
_DBL = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI2FpI8FqParamsE6CalledI10MulFoldMmaEEEvPKjS9_S9_PjSA_SA_xi"
_DBL_INLINE = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI2FpI8FqParamsE10MulFoldMmaEEvPKjS7_S7_PjS8_S8_xi"
_G2_DBL = "_ZN39_GLOBAL__N__56a1e2f0_13_curve_fold_cu_kFqN8k_doubleI3Fq27MulFoldEEvPKjS4_S4_PjS5_S5_xi"
_MUL_MMA = "_Z10mul_calledI10MulFoldMma8FqParamsE2FpIT0_ES4_S4_"


def test_mma_instances_keep_their_names():
    """The profiler's and ptxas's names of the tensor-core instances map to
    g1_madd_scan_fold / g1_double_fold (the mode's name holds MulFold), a
    G2 fold instance keeps its own name, and the called multiply is no
    kernel of the kernels line."""
    _root_on_path()
    import chip_smoke

    for name, want in _NAMES.items():
        assert chip_smoke.kernel_key(name) == want, name
    assert _build.short_name(_SCAN) == "k_madd_scan<FqParams,Called<MulFoldMma>>"
    assert _build.short_name(_DBL_INLINE) == "k_double<FqParams,MulFoldMma>"
    assert [chip_smoke.instance_name(_build.short_name(n)) for n in (_SCAN, _DBL, _DBL_INLINE, _G2_DBL)] == [
        "g1_madd_scan_fold", "g1_double_fold", "g1_double_fold", "g2_double_fold"]
    assert _build.short_name(_MUL_MMA) == "mul_called<MulFoldMma,FqParams>"
    assert chip_smoke.instance_name(_build.short_name(_MUL_MMA)) is None
    assert set(hf.MMA_KERNELS) <= set(chip_smoke.FOLD_KERNELS) and set(hf.MMA_KERNELS) <= set(hf.KERNELS)
    assert {"vs_curve_fold_mma_upload", "vs_curve_fold_mma_info"} <= set(_build.UNITS["curve_fold.cu"])


# cuobjdump -sass of the curve library as the card's toolkit writes it: each
# kernel's code holds the device functions it calls out of line (Called<M>'s
# multiply) behind their CALL targets
_SASS = f"""
	code for sm_90a
		Function : {_SCAN}
        /*0100*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0110*/                   CALL.REL.NOINC 0x140 ;
        /*0120*/              @!P0 BRA 0x100 ;
        /*0130*/                   EXIT ;
        /*0140*/                   FFMA R21, R145, R53, R68 ;
        /*0150*/                   LDSM.16.M88.4 R40, [R2] ;
        /*0160*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0170*/                   IMMA.16832.U8.S8 R12, R48.ROW, R44.COL, R12 ;
        /*0180*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_DBL}
        /*0200*/                   CALL.REL.NOINC 0x230 ;
        /*0210*/                   CALL.REL.NOINC 0x230 ;
        /*0220*/                   EXIT ;
        /*0230*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
        /*0240*/                   RET.REL.NODEC R20 0x0 ;
		Function : {_G2_DBL}
        /*0300*/                   CALL.REL.NOINC 0x320 ;
        /*0310*/                   EXIT ;
        /*0320*/                   FFMA R1, R2, R3, R4 ;
        /*0330*/                   IDP.4A.U8.S8 R4, R8, c[0x3][0x0], R4 ;
        /*0340*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_counts_hold_the_called_multiply():
    """[sass] counts a kernel's instructions with those of the multiply it
    calls out of line, which cuobjdump lists inside the kernel's code: the
    tensor-core instances show IMMA and no IDP, the G2 fold doubling the
    dp4a of mul_fold, each under its kernels-line name."""
    _root_on_path()
    import chip_smoke

    assert chip_smoke.sass_counts(_SASS) == {
        "g1_madd_scan_fold": {"IMMA": 2, "IDP": 0, "FFMA": 1, "all": 9},
        "g1_double_fold": {"IMMA": 1, "IDP": 0, "FFMA": 0, "all": 5},
        "g2_double_fold": {"IMMA": 0, "IDP": 1, "FFMA": 1, "all": 5},
    }


def test_fold_launcher_uploads_the_b_operand_once_a_card(monkeypatch):
    """hopper_field._launcher puts the fold unit's matrices in place before
    a fold launcher is handed out, once per card: the dp4a fold's packed
    matrices of Fq and Fr, and the tensor-core fold's B operand
    (fold_mul.mma_operand of Fq, N x K bytes); loop uploads nothing."""
    calls = []

    def recorder(name):
        def upload(field, ptr, n):
            calls.append((name, field, n))
            return 0

        upload.__name__ = name
        return upload

    lib = type("Lib", (), {n: staticmethod(recorder(n)) for n in ("vs_curve_fold_upload", "vs_curve_fold_mma_upload")})
    lib.vs_double_fold, lib.vs_double = "fold launcher", "loop launcher"
    monkeypatch.setattr(hf, "_lib", lambda: lib)
    monkeypatch.setattr(hf, "_fold_uploaded", set())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for index in (0, 0, 1):
        assert hf._launcher("vs_double", "fold", torch.device("cuda", index)) == "fold launcher"
    assert hf._launcher("vs_double", "loop", torch.device("cuda", 2)) == "loop launcher"
    one_card = [("vs_curve_fold_upload", 0, fold_mul.packed_matrix(lb.FQ).size),
                ("vs_curve_fold_upload", 1, fold_mul.packed_matrix(lb.FR).size),
                ("vs_curve_fold_mma_upload", 0, fold_mul.mma_operand(lb.FQ).size)]
    assert calls == one_card * 2
    assert fold_mul.mma_operand(lb.FQ).size == 56 * 288
