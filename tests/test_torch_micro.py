"""The multiply probes K7-K10 (``vote_saver_tpu_torch.micro``) on the CPU,
and the port's entry points defaulting to the card.

Each probe's plain version runs at a few lanes against the host oracle: the
chain probes end at x * (y R^-1)^depth on every checked lane, in each
multiplier mode, and their sum output starts chains 1.. where the JAX
probes do (K7 along the lane's row of 128, K8 at its own element rotated by
16k bits); every K9 kind, its 8-chain forms included, equals its
Python-integer (or correctly rounded float32) oracle bit for bit, on the
JAX probe's constant inputs and on K9's per-lane parity inputs, which give
the lanes different results; K1 agrees across the modes.  The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Without a card, a call that names no device must raise, not run on the
CPU.
"""

import ctypes

import numpy as np
import pytest
import torch

from vote_saver_tpu_torch import cli, entry, micro, run_election, scale, sdk
from vote_saver_tpu_torch.circuit import witness_dev
from vote_saver_tpu_torch.frontends import c_api, service
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import merkle, pedersen_ops
from vote_saver_tpu_torch.parallel import sharded
from vote_saver_tpu_torch.params import Q
from vote_saver_tpu_torch.protocol import groth16, phases
from vote_saver_tpu_torch.testing import torch_threads
from vote_saver_tpu_torch.utils.rng import FrRandom


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _start(probe, xs, i, k):
    """Host oracle of where chain k of lane i starts: K7 (bench.py:288-291)
    at the lane k further along its own row of 128 (a short last row rolls
    within itself), K8 (scripts/micro_cios_loop.py:96) at its own element
    rotated right by 16k bits."""
    if micro.start_of(probe) == "limbs":
        v = xs[i]
        return ((v >> (16 * k)) | (v << (384 - 16 * k))) & ((1 << 384) - 1)
    r0 = i - i % 128
    m = min(128, len(xs) - r0)
    return xs[r0 + (i - r0 + k) % m]


@pytest.mark.parametrize("probe", list(micro.CHAIN_PROBES))
def test_chain_probe_plain_matches_host_oracle(probe):
    r = micro.chain_probe(probe, "cpu", parity_lanes=5, reps=2)
    _idx, mode, chains, unroll, _mul = micro.CHAIN_PROBES[probe]
    assert r["parity"] and r["parity_depth"] == 2 * unroll and r["mode"] == mode
    assert "ms" not in r  # no rate from a CPU run
    # the sum output, on a full row and a short one: chains 1.. start where
    # the JAX probe starts them
    lanes = 128 + 5
    xs, ys, a, b = micro._parity_inputs(lanes, "cpu")
    out0, out1 = micro.run_chain(probe, a, b)
    assert torch.equal(out0, micro.mul_chain_plain(mode, 1, unroll, a, b, start=micro.start_of(probe))[0])
    if chains > 1:
        rinv = pow(lb.FQ.mont_r, -1, Q)
        want = [sum(_start(probe, xs, i, k) * pow(ys[i] * rinv % Q, unroll, Q) for k in range(1, chains)) % Q
                for i in range(lanes)]
        assert list(lb.tensor_to_ints(out1, lb.FQ, mont=False)) == want
    else:
        assert out1 is None


@pytest.mark.parametrize("kind", list(micro.OP_KINDS))
def test_op_plain_matches_host_oracle(kind):
    flt = kind.startswith("f32")
    x0, y0 = (0x3F800000, 0x40400000) if flt else (1, 3)
    rnd = np.random.default_rng(7)
    xs = [x0] + ([0x3F000000, 0x3FC00000] if flt else [int(v) for v in rnd.integers(0, 1 << 32, 2)])
    ys = [y0] + ([0x3F800000, 0x40000000] if flt else [int(v) for v in rnd.integers(0, 1 << 32, 2)])
    x = torch.tensor(np.array(xs, np.uint32).view(np.int32))
    y = torch.tensor(np.array(ys, np.uint32).view(np.int32))
    got = micro.run_op(kind, x, y).numpy().view(np.uint32).tolist()
    assert got == [micro.op_oracle(kind, a, b) for a, b in zip(xs, ys)]
    r = micro.op_throughput("cpu", lanes=3, kinds=(kind,))[kind]
    assert r["parity"] and "giter_s" not in r


@pytest.mark.parametrize("kind", list(micro.OP_KINDS))
def test_op_parity_inputs_differ_by_lane(kind):
    xs, ys = micro.op_inputs(kind, 12)
    assert len(set(zip(xs.tolist(), ys.tolist()))) == 12
    x, y = (torch.from_numpy(v.view(np.int32)) for v in (xs, ys))
    got = micro.op_plain(kind, x, y).numpy().view(np.uint32).tolist()
    if kind in ("u32_mul", "u32_mulmask"):
        # x * y (y + 1) ... (y + 511) is divisible by 2^32 whatever x and y:
        # the JAX probe's result is 0 in every lane; the _x8 forms, whose
        # chains step their constants by 8, run the same indexing and keep
        # their lanes apart
        assert set(got) == {0}
    else:
        assert len(set(got)) > 1, "a kernel that read one lane for all would pass"
    assert got[:3] == [micro.op_oracle(kind, int(a), int(b)) for a, b in zip(xs[:3], ys[:3])]


@pytest.mark.parametrize("wide_giter_s, want", [(5000.0, "guide"), (9000.0, "k9")])
def test_card_int_rates_take_the_larger(monkeypatch, wide_giter_s, want):
    """A bound divides by the faster of the documented and the measured
    rate, so that no kernel's bound is larger than the card allows."""

    class _Smi:
        stdout = "1980\n"

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(micro.subprocess, "run", lambda *a, **k: _Smi())
    monkeypatch.setattr(micro.torch.cuda, "get_device_properties", lambda i: _Props())
    k9 = {k: dict(giter_s=1.0, gop_s=1.0) for k in micro.OP_KINDS}
    k9["u32_mul_wide_x8"]["giter_s"] = wide_giter_s
    rt = micro.card_int_rates(k9)
    mul32 = 64 * 132 * 1980e6  # 64 32-bit multiply results per clock per SM
    assert rt["guide_mul_wide"] == mul32 / 2 and rt["mul32"] == mul32 and rt["issue"] == 2 * mul32
    assert rt["mul_wide"] == (mul32 / 2 if want == "guide" else wide_giter_s * 1e9)


def test_plain_fma_rounds_once():
    """x * y + 1 = 1 + 2^-24 + 2^-60: rounded to float64 first it lands on
    the float32 midpoint 1 + 2^-24 and then rounds to even (1.0); fmaf
    rounds once, up to 1 + 2^-23."""
    x = torch.tensor([2.0**-24 * (1 + 2.0**-12)], dtype=torch.float32)
    y = torch.tensor([1 - 4095 * 2.0**-24], dtype=torch.float32)
    assert (x.double() * y.double() + 1).float().item() == 1.0
    assert micro._fma_f32(x, y, 1).item() == 1 + 2.0**-23
    frac = __import__("fractions").Fraction
    assert micro._f32_round(frac(x.item()) * frac(y.item()) + 1) == 1 + 2.0**-23


def test_op_oracle_rounds_float32_correctly():
    third = micro._f32_round(__import__("fractions").Fraction(1, 3))
    assert third == float(np.float32(1 / 3))
    assert micro._f32_round(__import__("fractions").Fraction(2) ** 130) == float("inf")
    # u32_mul_wide is lo * (y + k) + hi on the full 64-bit value
    assert micro.op_oracle("u32_mul_wide", 1, 3) != micro.op_oracle("u32_mul", 1, 3)


def test_mont_mul_modes_probe_on_cpu():
    r = micro.mont_mul_modes("cpu", lanes=6)
    assert set(r) == {f"{n}_{m}" for n in ("fq", "fr") for m in hf.MODES}
    assert all(v["parity"] and v["max_abs_err"] == 0 and "ms" not in v for v in r.values())


def _default_calls(workdir=None):
    cs_stub = object()
    return {
        "prepare_vote_context": lambda: phases.prepare_vote_context(2, 64, b"", b"", b"", b"", b"", b""),
        "init_admin_phase_generate_keys": lambda: phases.init_admin_phase_generate_keys(2, 64, FrRandom(1)),
        "groth16.setup": lambda: groth16.setup(cs_stub, FrRandom(1)),
        "groth16.prove": lambda: groth16.prove(None, np.zeros((1, 2), dtype=object), FrRandom(1)),
        "generate_witness_device": lambda: witness_dev.generate_witness_device(None, [0], [0], [[0]], [0], [[0]]),
        "micro.field_mul": lambda: micro.field_mul("loop"),
        "micro.cios_loop": lambda: micro.cios_loop(),
        "micro.mul_chain": lambda: micro.mul_chain(),
        "micro.op_throughput": lambda: micro.op_throughput(),
        "micro.mont_mul_modes": lambda: micro.mont_mul_modes(),
        "pedersen_ops.window_tables": lambda: pedersen_ops.window_tables(85),
        "pedersen_ops.pedersen_hash_bits": lambda: pedersen_ops.pedersen_hash_bits(np.zeros((1, 255)), 255),
        "merkle.build_tree": lambda: merkle.build_tree(np.zeros((2, 255), np.int32)),
        "merkle.verify_path": lambda: merkle.verify_path(np.zeros(255), 0, np.zeros((1, 255)), np.zeros(255)),
        "init_admin_phase_generate_data": lambda: phases.init_admin_phase_generate_data(2, 64, [], FrRandom(1)),
        "sdk.admin_keygen": lambda: sdk.admin_keygen(2, 64, FrRandom(1)),
        "sdk.init_election": lambda: sdk.init_election([], 2, 64, FrRandom(1)),
        "sdk.generate_vote": lambda: sdk.generate_vote(sdk.AdminKeys(b"", b""), sdk.Election(b"", b"", b""), 0, 0, b""),
        "sdk.generate_votes": lambda: sdk.generate_votes(sdk.AdminKeys(b"", b""), sdk.Election(b"", b"", b""), [0], [0],
                                                         [b""]),
        "cli.main": lambda: cli.main(["--phase", "init_admin", "--tree-depth", "2", "--workdir", str(workdir)]),
        "service.handle": lambda: service.handle({"method": "init_election", "params": {"public_keys": []}}),
        "c_api.admin_keygen": lambda: c_api.admin_keygen(2, 64, None, None, None, None, None),
        "c_api.init_election": lambda: c_api.init_election(2, 64, ctypes.pointer(c_api.SuperBuffer(0, None)),
                                                           None, None, None),
        "scale.run": lambda: scale.run(1),
        "python -m vote_saver_tpu_torch.scale": lambda: scale.main(["--config", "1"]),
        "python -m vote_saver_tpu_torch.scale --points 2": lambda: scale.main(["--config", "1", "--points", "2"]),
        "entry.entry": lambda: entry.entry(),
        "entry.dryrun_multichip": lambda: entry.dryrun_multichip(4),
        "python -m vote_saver_tpu_torch.entry": lambda: entry.main([]),
        "sharded.spawn": lambda: sharded.spawn(entry.run_cases, ({},), 2),
        "run_election.run": lambda: run_election.run(),
        "python -m vote_saver_tpu_torch.run_election": lambda: run_election.main([]),
    }


@pytest.mark.parametrize("entry", list(_default_calls()))
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without a card, the default device raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_calls(tmp_path)[entry]()
    assert lb.device_of("cpu") == torch.device("cpu")


_CHAIN_SASS = """
		Function : _Z15k_mul_chain_ptxI8FqParams10MulLoopPtxLi4ELi6ELi0EEvPKjS2_PjS3_x
        /*0100*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0110*/                   IMAD.X R5, R2, R3, R5, P0 ;
        /*0120*/                   IMAD.HI.U32 R6, R2, R3, R6 ;
        /*0130*/              @!P1 IADD3.X R7, R7, RZ, RZ, P0, !PT ;
        /*0140*/                   IMAD.MOV.U32 R8, RZ, RZ, R9 ;
        /*0150*/                   SEL R1, R2, R3, P0 ;
        /*0160*/                   EXIT ;
		Function : _Z15k_mul_chain_mmaI8FqParamsLi4ELi6EEvPKjS2_PjS3_x
        /*0100*/                   IMMA.16832.U8.S8 R8, R40.ROW, R44.COL, R8 ;
"""


def test_sass_mix_counts_each_class_per_multiply():
    """micro.sass_mix: the loop / v1 chain probes' SASS by opcode class, over
    the instance's chains x unroll multiplies; the fold probes left out."""
    mix = micro.sass_mix(_CHAIN_SASS)
    assert set(mix) == {"k7_loop"}
    per = {c: n * 24 for c, n in mix["k7_loop"].items()}
    assert per == {"IMAD.WIDE": 1, "IMAD.HI": 1, "IMAD.MOV": 1, "IMAD": 1, "IADD3": 1, "SEL/ISETP": 1, "MOV": 0,
                   "other": 1, "all": 7}
