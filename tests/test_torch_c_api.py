"""The port's C ABI and the C clients over the port's JSON service.

Mirrors ``tests/test_c_api.py``: the six exports round-trip through real C
function pointers (address -> CFUNCTYPE cast -> callee-allocated
out-buffers) at depth 2 under ``c_api.set_device("cpu")``.  The one vote
(B = 1) takes ``test_torch_stream.py``'s host stand-ins for the five MSMs
and the ballot tail, and admin setup takes its host-native arm, which
writes the same CRS as setup through the plain K3d
(``test_torch_setup.py``) in seconds rather than minutes on the CPU.

Mirrors ``tests/test_c_client.py`` and ``test_mobile_client.py``'s keypair
and tally case: ``native/demo_client.c`` and ``native/vs_mobile.c``, built
unchanged, start the "python" they are given with ``-m
vote_saver_tpu.frontends.service``; here that "python" is a two-line
script that ignores its arguments and starts the port's service on the
CPU instead.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from vote_saver_tpu_torch.frontends import c_api
from vote_saver_tpu_torch.frontends.c_api import Buffer, SuperBuffer
from vote_saver_tpu_torch.protocol import ballot_dev, groth16, phases
from vote_saver_tpu_torch.testing import torch_threads

from test_torch_stream import _host_tail
from test_torch_vote import _host_msms

_REPO = pathlib.Path(__file__).resolve().parent.parent
_NATIVE = _REPO / "native"
_keep = []  # keep-alive for every ctypes object built by the helpers


def _buf():
    p = ctypes.pointer(Buffer(0, None))
    _keep.append(p)
    return p


def _in(blob: bytes):
    arr = ctypes.create_string_buffer(blob, len(blob))
    p = ctypes.pointer(Buffer(len(blob), ctypes.cast(arr, ctypes.POINTER(ctypes.c_char))))
    _keep.extend((arr, p))
    return p


def _super(blobs):
    bufs = [_in(b) for b in blobs]
    ptr_arr = (ctypes.POINTER(Buffer) * len(bufs))(*bufs)
    sb = ctypes.pointer(SuperBuffer(len(bufs), ptr_arr))
    _keep.extend((ptr_arr, sb))
    return sb


def _read(buf) -> bytes:
    return ctypes.string_at(buf.contents.ptr, buf.contents.size)


@pytest.fixture
def cpu_abi(monkeypatch):
    """The exports resolved from their raw C addresses, on the CPU; the
    module's device is the card again afterwards."""
    real_setup = groth16.setup
    monkeypatch.setattr(groth16, "setup", lambda cs, rng, device: real_setup(cs, rng, "host"))
    monkeypatch.setattr(groth16, "prove_msms", _host_msms)
    monkeypatch.setattr(ballot_dev, "finalize_ballots_device", _host_tail)
    c_api.set_device("cpu")
    try:
        with torch_threads(4):
            yield {name: c_api._SIGS[name](addr) for name, addr in c_api.function_pointers().items()}
    finally:
        c_api.set_device("cuda")


def test_six_call_round_trip(cpu_abi):
    fns = cpu_abi
    c_api.seed(0xCAB1)
    depth, eid_bits = 2, 64
    assert set(c_api.EXPORTS) == set(fns) == {"generate_voter_keypair", "admin_keygen", "init_election",
                                              "generate_vote", "tally_votes", "verify_tally", "free_buffer"}

    pks, sks = [], []
    for _ in range(2):
        pk_out, sk_out = _buf(), _buf()
        fns["generate_voter_keypair"](pk_out, sk_out)
        pks.append(_read(pk_out))
        sks.append(_read(sk_out))
        fns["free_buffer"](pk_out)
        assert pk_out.contents.size == 0 and len(pks[-1]) == len(sks[-1]) == 32

    outs = [_buf() for _ in range(5)]
    fns["admin_keygen"](depth, eid_bits, *outs)
    pk_crs, vk_crs, pk_eid, sk_eid, vk_eid = (_read(o) for o in outs)
    assert len(pk_crs) > len(vk_crs) > 0

    eid_out, rt_out, tree_out = _buf(), _buf(), _buf()
    fns["init_election"](depth, eid_bits, _super(pks), eid_out, rt_out, tree_out)
    eid, rt, tree = _read(eid_out), _read(rt_out), _read(tree_out)
    assert len(tree) == 32 * 7
    # the tree on the CPU device path is the oracle's
    assert tree == phases.init_admin_phase_generate_data(depth, eid_bits, pks, None, device="host")[2]

    proof_o, pinput_o, ct_o, sn_o = _buf(), _buf(), _buf(), _buf()
    fns["generate_vote"](depth, eid_bits, 1, 7, _in(tree), _in(rt), _in(eid), _in(sks[1]), _in(pk_eid),
                         _in(pk_crs), _in(vk_crs), proof_o, pinput_o, ct_o, sn_o)
    assert proof_o.contents.size == 192 and sn_o.contents.size > 0
    ct = _read(ct_o)
    assert phases.verify_ballot(_read(proof_o), _read(pinput_o), ct, vk_eid, vk_crs)

    dec_o, res_o = _buf(), _buf()
    fns["tally_votes"](depth, _in(sk_eid), _in(vk_eid), _in(pk_crs), _in(vk_crs), _super([ct]), dec_o, res_o)
    dec_proof, voting_res = _read(dec_o), _read(res_o)
    n = int.from_bytes(voting_res[:8], "big")
    counts = [int.from_bytes(voting_res[8 + 32 * i : 8 + 32 * (i + 1)], "big") for i in range(n)]
    assert counts[7] == 1 and sum(counts) == 1

    for res, want in ((voting_res, True), (voting_res[:-1] + bytes([voting_res[-1] ^ 1]), False)):
        ok = fns["verify_tally"](depth, _super([ct]), _in(vk_eid), _in(pk_crs), _in(vk_crs), _in(dec_proof), _in(res))
        assert bool(ok) is want


# ---------------------------------------------------------------------------
# the C clients, unchanged, over the port's service
# ---------------------------------------------------------------------------


def _cc() -> str:
    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "no C compiler on this rig"
    return cc


@pytest.fixture(scope="module")
def port_python(tmp_path_factory):
    """The "python" the C clients start: it ignores its arguments (``-m
    vote_saver_tpu.frontends.service``) and starts the port's service."""
    exe = tmp_path_factory.mktemp("port_service") / "python"
    exe.write_text(f"#!/bin/sh\nexec {sys.executable} -m vote_saver_tpu_torch.frontends.service --device cpu\n")
    exe.chmod(0o755)
    return exe


def test_c_client_embeds_the_ports_service(tmp_path, port_python):
    demo = tmp_path / "demo_client"
    subprocess.run([_cc(), "-O2", "-o", str(demo), str(_NATIVE / "demo_client.c"), str(_NATIVE / "vs_client.c")],
                   check=True, capture_output=True, text=True)
    proc = subprocess.run([str(demo), str(port_python)], capture_output=True, text=True, timeout=300, cwd=str(_REPO))
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "DEMO-OK" in proc.stdout and "pk 32 bytes, sk 32 bytes" in proc.stdout


def test_mobile_keypair_and_tally_over_the_ports_service(tmp_path, port_python, election):
    """The JNI bridge's keypair and tally legs through vs_mobile and the
    port's service (the vote leg is left out, as in the JAX package's fast
    case)."""
    smoke = tmp_path / "mobile_smoke"
    subprocess.run([_cc(), "-O2", "-I", str(_NATIVE / "jni_compat"), "-o", str(smoke),
                    str(_NATIVE / "mobile_smoke.c"), str(_NATIVE / "vs_android.c"), str(_NATIVE / "vs_mobile.c"),
                    str(_NATIVE / "vs_client.c")], check=True, capture_output=True, text=True)
    e = election
    cts = [b[2] for b in e["ballots"]]
    dec_proof, voting_res = phases.tally_admin_phase(2, cts, e["sk_eid"], e["vk_eid"], e["pk_crs"], e["vk_crs"])
    data = tmp_path / "blobs"
    data.mkdir()
    blobs = dict(tree=e["tree"], rt=e["rt"], eid=e["eid"], sk=e["voters"][0][1], pk_eid=e["pk_eid"],
                 pk_crs=e["pk_crs"], vk_crs=e["vk_crs"], vk_eid=e["vk_eid"], dec_proof=dec_proof,
                 voting_res=voting_res, **{f"ct{i}": ct for i, ct in enumerate(cts)})
    for name, blob in blobs.items():
        (data / name).write_bytes(blob)
    out = tmp_path / "out"
    out.mkdir()
    ref = e["ballots"][0]
    proc = subprocess.run([str(smoke), str(port_python), str(data), str(out), *(str(len(x)) for x in ref),
                           str(len(e["ballots"])), "0"], capture_output=True, text=True, timeout=600,
                          cwd=str(_REPO), env=dict(os.environ))
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "MOBILE-OK" in proc.stdout
