"""C-ABI frontend: the reference's buffer{size, ptr} surface over ctypes.

Mirrors the WASM frontend's six exported functions signature-for-signature
(reference bin/cli/src/wasm.cpp:62-201: generate_voter_keypair, admin_keygen,
init_election, generate_vote, tally_votes, verify_tally over buffer<char> /
buffer<buffer<char>*> structs) — the same surface the Android/iOS frontends
subset (android.cpp:75-130, ios.mm:23-100).  A non-Python embedder gets real
C function pointers:

    from vote_saver_tpu_torch.frontends import c_api
    ptrs = c_api.function_pointers()   # {name: int address}, CFUNCTYPE ABI

or, embedding CPython, call the CFUNCTYPE objects in `c_api.EXPORTS`
directly.  Memory contract matches wasm.cpp: out-buffers are allocated by
the callee (`blob_to_buffer`, wasm.cpp:38-44) and owned by the library;
`free_buffer` releases one (the WASM build leaks them into the Emscripten
heap — here they are tracked and freeable).

Counterpart of ``vote_saver_tpu/frontends/c_api.py``, with the same
structs, exports and signatures.  The C signatures carry no device, so
the module holds one: the card, unless ``set_device`` names another
("cpu" runs the kernels' plain versions).
"""

from __future__ import annotations

import ctypes

from ..params import DEFAULT_EID_BITS
from ..protocol import phases
from ..utils.rng import FrRandom


class Buffer(ctypes.Structure):
    """struct buffer<char> { size_t size; char* ptr; } (wasm.cpp:33-36)."""

    _fields_ = [("size", ctypes.c_size_t), ("ptr", ctypes.POINTER(ctypes.c_char))]


class SuperBuffer(ctypes.Structure):
    """struct buffer<buffer<char>*> (wasm.cpp super_buffer, :51-60)."""

    _fields_ = [("size", ctypes.c_size_t), ("ptr", ctypes.POINTER(ctypes.POINTER(Buffer)))]


_BP = ctypes.POINTER(Buffer)
_SBP = ctypes.POINTER(SuperBuffer)

# callee-allocated out-buffer storage: addr -> keep-alive byte array
_live: dict = {}

_rng = FrRandom()
_device = "cuda"


def seed(value: int) -> None:
    """Deterministic RNG for reproducible runs (the reference srand_once
    analog, common.hpp:801-808)."""
    global _rng
    _rng = FrRandom(value)


def set_device(name: str) -> None:
    """The device admin_keygen, init_election and generate_vote run on:
    "cuda" (the default), "cuda:<i>" or "cpu"."""
    global _device
    _device = name


def _fill(out: "_BP", blob: bytes) -> None:
    arr = ctypes.create_string_buffer(blob, len(blob))
    out.contents.size = len(blob)
    out.contents.ptr = ctypes.cast(arr, ctypes.POINTER(ctypes.c_char))
    _live[ctypes.addressof(arr)] = arr


def _read(buf: "_BP") -> bytes:
    b = buf.contents
    return ctypes.string_at(b.ptr, b.size)


def _read_super(sb: "_SBP") -> list[bytes]:
    s = sb.contents
    return [_read(s.ptr[i]) for i in range(s.size)]


def free_buffer(buf: "_BP") -> None:
    b = buf.contents
    addr = ctypes.cast(b.ptr, ctypes.c_void_p).value
    _live.pop(addr, None)
    b.size = 0


# ---------------------------------------------------------------------------
# The six exports (wasm.cpp:62-201 signatures)
# ---------------------------------------------------------------------------


def generate_voter_keypair(pk_out: _BP, sk_out: _BP) -> None:
    pk, sk = phases.init_voter_phase(0, _rng)
    _fill(pk_out, pk)
    _fill(sk_out, sk)


def admin_keygen(
    tree_depth: int, eid_bits: int,
    pk_crs_out: _BP, vk_crs_out: _BP, pk_eid_out: _BP, sk_eid_out: _BP,
    vk_eid_out: _BP,
) -> None:
    blobs = phases.init_admin_phase_generate_keys(tree_depth, eid_bits, _rng, _device)
    for out, blob in zip((pk_crs_out, vk_crs_out, pk_eid_out, sk_eid_out, vk_eid_out), blobs):
        _fill(out, blob)


def init_election(
    tree_depth: int, eid_bits: int, public_keys: _SBP,
    eid_out: _BP, rt_out: _BP, merkle_tree_out: _BP,
) -> None:
    pks = _read_super(public_keys)
    eid, rt, tree = phases.init_admin_phase_generate_data(tree_depth, eid_bits, pks, _rng, _device)
    _fill(eid_out, eid)
    _fill(rt_out, rt)
    _fill(merkle_tree_out, tree)


def generate_vote(
    tree_depth: int, eid_bits: int, voter_idx: int, vote: int,
    merkle_tree: _BP, rt: _BP, eid: _BP, sk: _BP, pk_eid: _BP,
    pk_crs: _BP, vk_crs: _BP,
    proof_out: _BP, pinput_out: _BP, ct_out: _BP, sn_out: _BP,
) -> None:
    proof, pinput, ct, sn = phases.vote_phase(
        tree_depth, eid_bits, voter_idx, vote,
        _read(merkle_tree), _read(rt), _read(eid), _read(sk), _read(pk_eid),
        _read(pk_crs), _read(vk_crs), _rng, _device,
    )
    _fill(proof_out, proof)
    _fill(pinput_out, pinput)
    _fill(ct_out, ct)
    _fill(sn_out, sn)


def tally_votes(
    tree_depth: int, sk_eid: _BP, vk_eid: _BP, pk_crs: _BP, vk_crs: _BP,
    cts: _SBP, dec_proof_out: _BP, voting_res_out: _BP,
) -> None:
    dec_proof, voting_res = phases.tally_admin_phase(
        tree_depth, _read_super(cts), _read(sk_eid), _read(vk_eid),
        _read(pk_crs), _read(vk_crs),
    )
    _fill(dec_proof_out, dec_proof)
    _fill(voting_res_out, voting_res)


def verify_tally(
    tree_depth: int, cts: _SBP, vk_eid: _BP, pk_crs: _BP, vk_crs: _BP,
    dec_proof: _BP, voting_res: _BP,
) -> bool:
    return phases.tally_voter_phase(
        tree_depth, _read_super(cts), _read(vk_eid), _read(pk_crs),
        _read(vk_crs), _read(voting_res), _read(dec_proof),
    )


# ---------------------------------------------------------------------------
# CFUNCTYPE export table — real C calling convention (cdecl) wrappers.
# ---------------------------------------------------------------------------

_SIGS = {
    "generate_voter_keypair": ctypes.CFUNCTYPE(None, _BP, _BP),
    "admin_keygen": ctypes.CFUNCTYPE(
        None, ctypes.c_size_t, ctypes.c_size_t, _BP, _BP, _BP, _BP, _BP
    ),
    "init_election": ctypes.CFUNCTYPE(
        None, ctypes.c_size_t, ctypes.c_size_t, _SBP, _BP, _BP, _BP
    ),
    "generate_vote": ctypes.CFUNCTYPE(
        None, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        _BP, _BP, _BP, _BP, _BP, _BP, _BP, _BP, _BP, _BP, _BP,
    ),
    "tally_votes": ctypes.CFUNCTYPE(
        None, ctypes.c_size_t, _BP, _BP, _BP, _BP, _SBP, _BP, _BP
    ),
    "verify_tally": ctypes.CFUNCTYPE(
        ctypes.c_bool, ctypes.c_size_t, _SBP, _BP, _BP, _BP, _BP, _BP
    ),
    "free_buffer": ctypes.CFUNCTYPE(None, _BP),
}

EXPORTS = {name: sig(globals()[name]) for name, sig in _SIGS.items()}


def function_pointers() -> dict[str, int]:
    """{export name: C function address} — what a dlopen-style embedder
    resolves (the Emscripten EXPORTED_FUNCTIONS analog,
    bin/cli/CMakeLists.txt:121)."""
    return {name: ctypes.cast(fn, ctypes.c_void_p).value for name, fn in EXPORTS.items()}
