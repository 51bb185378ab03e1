"""The port's copies of the JAX package's jax-free modules, against the
originals.

The port imports nothing of ``vote_saver_tpu``: it keeps its own copies of
``params``, ``refimpl/``, ``utils/rng``, ``circuit/{r1cs,gadgets,voting}``,
the byte helpers, writers and parse cache of ``protocol/marshal`` and
``native_bridge``
(which builds ``native/vs_native.cpp`` into the port's own build
directory), and byte for byte ``config``, ``utils/logging`` and the chain
layer (``chain/``); ``utils/profiling`` keeps its timers unchanged.  Each copy must give exactly what its original gives: the
constants, the seeded ``FrRandom`` streams, the depth-2 voting circuit's
matrices and host witness, the wire bytes of the depth-2 election, the
oracle pairing and Pedersen hash, and the native MSM, fixed-base products
and MSM schedules.
"""

import dataclasses
import inspect
import pathlib
import random
import types

import numpy as np
import pytest

from vote_saver_tpu import native_bridge as jnb
from vote_saver_tpu import params as jparams
from vote_saver_tpu.circuit import voting as jvoting
from vote_saver_tpu.protocol import marshal as jM
from vote_saver_tpu.refimpl import curves as jrc
from vote_saver_tpu.refimpl import jacobian as jrj
from vote_saver_tpu.refimpl import pairing as jrp
from vote_saver_tpu.refimpl import pedersen as jrpd
from vote_saver_tpu.utils.rng import FrRandom as JFrRandom
from vote_saver_tpu_torch import native_bridge as nb
from vote_saver_tpu_torch import params
from vote_saver_tpu_torch.circuit import voting
from vote_saver_tpu_torch.ops import merkle
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.protocol import keys
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.refimpl import pairing as rp
from vote_saver_tpu_torch.refimpl import pedersen as rpd
from vote_saver_tpu_torch.utils.rng import FrRandom


def test_params_constants_match():
    names = [n for n in dir(jparams) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(params, n) == getattr(jparams, n), n
    spec, jspec = params.FieldSpec("fq", params.Q, 32, 12), jparams.FieldSpec("fq", jparams.Q, 32, 12)
    x = 0x1234_5678_9ABC_DEF0 << 200
    assert (spec.n0_inv, spec.mont_r2, spec.to_limbs(x), spec.to_mont(x)) == \
        (jspec.n0_inv, jspec.mont_r2, jspec.to_limbs(x), jspec.to_mont(x))


def test_frrandom_streams_match():
    ours, theirs = FrRandom(0xC41B5), JFrRandom(0xC41B5)
    assert [ours() for _ in range(20)] == [theirs() for _ in range(20)]
    assert ours.bits(255) == theirs.bits(255)
    assert FrRandom(b"seed")() == JFrRandom(b"seed")()


def test_voting_circuit_and_host_witness_match():
    circ, jcirc = voting.build_voting_circuit(2, 64), jvoting.build_voting_circuit(2, 64)
    assert (circ.cs.num_constraints, circ.cs.num_vars, circ.cs.num_primary) == \
        (jcirc.cs.num_constraints, jcirc.cs.num_vars, jcirc.cs.num_primary)
    coo, jcoo = circ.cs.to_coo(), jcirc.cs.to_coo()
    for k in ("a", "b", "c"):
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(coo[k], jcoo[k])), k
    rng = FrRandom(61)
    sks = [rng.bits(params.SECRET_KEY_BITS) for _ in range(2)]
    pks = [rpd.pedersen_hash(sk) for sk in sks] + [[0] * params.PUBLIC_KEY_BITS] * 2
    levels = merkle.build_tree(np.array(pks, np.int32), device="host")
    eid = np.array([rng() % 2 for _ in range(64)], dtype=object)
    votes, vidx = np.array([3, 24]), np.array([0, 1])
    sib = np.stack([merkle.copath(levels, i) for i in vidx]).astype(object)
    args = (votes, eid, np.array(sks, dtype=object), vidx, sib)
    w, jw = circ.generate_witness(*args), jcirc.generate_witness(*args)
    assert np.array_equal(w.values, jw.values)
    assert circ.cs.is_satisfied(w.values)


def test_marshal_copy_matches_on_the_election(election):
    e = election
    for blob in (e["eid"], e["rt"]):
        assert M.de_scalar_vector(blob) == jM.de_scalar_vector(blob)
        assert M.ser_scalar_vector(M.de_scalar_vector(blob)) == blob
    sk_bits = M.de_bitarray(e["voters"][0][1], params.SECRET_KEY_BITS)
    assert sk_bits == jM.de_bitarray(e["voters"][0][1], params.SECRET_KEY_BITS)
    assert M.ser_bitarray(sk_bits) == jM.ser_bitarray(sk_bits) == e["voters"][0][1]
    tree = M.de_merkle_tree(e["tree"], 2)
    assert np.array_equal(tree, jM.de_merkle_tree(e["tree"], 2)) and M.ser_merkle_tree(tree) == e["tree"]
    bits = M.unpack_field_elements_to_bits(M.de_scalar_vector(e["eid"]), 64)
    assert bits == jM.unpack_field_elements_to_bits(jM.de_scalar_vector(e["eid"]), 64)
    assert M.pack_bits_to_field_elements(bits) == jM.pack_bits_to_field_elements(bits)
    pk = keys.de_groth16_pk(e["pk_crs"], coo=None)
    jpk = jM.de_groth16_pk(e["pk_crs"])
    assert pk.a_pts == jpk.a_pts and pk.b2_pts == jpk.b2_pts
    assert M.ser_groth16_pk(pk) == jM.ser_groth16_pk(jpk) == e["pk_crs"]
    assert M.ser_groth16_vk(keys.de_groth16_vk(e["vk_crs"])) == e["vk_crs"]
    for proof, _pinput, ct, _sn in e["ballots"]:
        assert M.de_g1(proof[:48]) == jM.de_g1(proof[:48]) and M.de_g2(proof[48:144]) == jM.de_g2(proof[48:144])
        assert M.ser_proof(keys.de_proof(proof)) == jM.ser_proof(jM.de_proof(proof)) == proof
        assert M.ser_ct(keys.de_ct(ct)) == jM.ser_ct(jM.de_ct(ct)) == ct


def test_marshal_chain_vectors_dec_proof_and_parse_cache_match():
    """The chain's 4-byte-prefix scalar vector, the prefix-agnostic reader,
    the decryption-proof writer and the parse cache, against the originals."""
    rnd = random.Random(64)
    xs = [0, 1, params.R - 1] + [rnd.randrange(params.R) for _ in range(22)]
    assert M.ser_scalar_vector_chain(xs) == jM.ser_scalar_vector_chain(xs)
    for blob in (M.ser_scalar_vector(xs), M.ser_scalar_vector_chain(xs), M.ser_scalar_vector([])):
        assert M.de_scalar_vector_any(blob) == jM.de_scalar_vector_any(blob)
    assert M.de_scalar_vector_any(M.ser_scalar_vector_chain(xs)) == xs
    dp = types.SimpleNamespace(d_pts=[None] + [rc.g1_mul(rc.g1_gen, x) for x in xs[1:20]])
    assert M.ser_dec_proof(dp) == jM.ser_dec_proof(dp)
    assert inspect.getsource(M._cached) == inspect.getsource(jM._cached)
    assert M._DE_CACHE_MAX == jM._DE_CACHE_MAX


def test_refimpl_pairing_and_pedersen_match():
    rnd = random.Random(62)
    a, b = rnd.randrange(1, params.R), rnd.randrange(1, params.R)
    p, q = rc.g1_mul(rc.g1_gen, a), rc.g2_mul(rc.g2_gen, b)
    assert p == jrc.g1_mul(jrc.g1_gen, a) and q == jrc.g2_mul(jrc.g2_gen, b)
    assert rp.pairing(p, q) == jrp.pairing(p, q)
    pairs = [(p, q), (rc.g1_neg(rc.g1_mul(rc.g1_gen, a * b % params.R)), rc.g2_gen)]
    assert rp.pairing_check(pairs) and jrp.pairing_check(pairs)
    bits = [rnd.getrandbits(1) for _ in range(2 * 255)]
    assert rpd.pedersen_hash(bits) == jrpd.pedersen_hash(bits)
    assert rpd.pedersen_point(bits[:100]) == jrpd.pedersen_point(bits[:100])


def test_native_bridge_copy_matches():
    assert nb.available() and jnb.available()
    assert nb._lib_path().parent.name == ".torch_build"
    rnd = random.Random(63)
    pts = jrj.FixedBaseHost(jrc.g1_gen, "g1").mul_many([rnd.randrange(1, params.R) for _ in range(64)])
    pts2 = jrj.FixedBaseHost(jrc.g2_gen, "g2").mul_many([rnd.randrange(1, params.R) for _ in range(16)])
    scalars = [rnd.randrange(params.R) for _ in range(64)]
    assert nb.msm(pts, scalars) == jnb.msm(pts, scalars)
    assert nb.msm(pts2, scalars[:16], group="g2") == jnb.msm(pts2, scalars[:16], group="g2")
    assert nb.fixed_base(rc.g1_gen, scalars[:8]) == jnb.fixed_base(jrc.g1_gen, scalars[:8])
    assert rj.FixedBaseHost(rc.g2_gen, "g2").mul_many(scalars[:4]) == \
        jrj.FixedBaseHost(jrc.g2_gen, "g2").mul_many(scalars[:4])
    sc = np.ascontiguousarray(np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in scalars * 2]))
    inf = np.array([i % 9 == 4 for i in range(64)])
    t1, d1, c1 = nb.sched_pass1(sc, 2, 64, 6, inf)
    t2, d2, c2 = jnb.sched_pass1(sc, 2, 64, 6, inf)
    assert t1 == t2 and np.array_equal(d1, d2) and np.array_equal(c1, c2)
    canon = 2 * d1.shape[1] << 5
    steps, lanes, orph_cnt = ms._fit_shape(c1.sum(axis=0, dtype=np.int64), t1, canon)
    orph_base = ms._merge_arrays(orph_cnt, canon, lanes)[2].astype(np.int32)
    args = (2, 64, 6, inf, c1, orph_base, steps, steps, lanes)
    codes = nb.sched_pass2(d1, *args)
    assert codes.any() and np.array_equal(codes, jnb.sched_pass2(d2, *args))


COPIES = ["config.py", "utils/logging.py", "chain/__init__.py", "chain/ballot_blob.py", "chain/contracts.py",
          "chain/tonos.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_jax_free_modules_are_verbatim_copies(rel):
    """config, the logging gate and the chain layer are the JAX package's
    files byte for byte (the chain's lazy imports of protocol.saver and
    protocol.groth16 resolve to the port's verifiers)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    assert (root / "vote_saver_tpu_torch" / rel).read_bytes() == (root / "vote_saver_tpu" / rel).read_bytes()


def test_config_and_profiling_match():
    from vote_saver_tpu import config as jconfig
    from vote_saver_tpu.utils import profiling as jprof
    from vote_saver_tpu_torch import config
    from vote_saver_tpu_torch.utils import profiling as prof

    assert config.DEFAULT == config.ProtocolConfig()
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    assert (config.DEFAULT.num_voters, config.DEFAULT.primary_input_size, config.DEFAULT.ciphertext_points) == \
        (jconfig.DEFAULT.num_voters, jconfig.DEFAULT.primary_input_size, jconfig.DEFAULT.ciphertext_points)
    for name in ("Timer", "mpoints_per_s", "mbutterflies_per_s"):
        assert inspect.getsource(getattr(prof, name)) == inspect.getsource(getattr(jprof, name)), name
    assert prof.mpoints_per_s(1 << 16, 0.5) == jprof.mpoints_per_s(1 << 16, 0.5)
    assert prof.mbutterflies_per_s(1 << 15, 0.25) == jprof.mbutterflies_per_s(1 << 15, 0.25)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace: a no-op for None; else a torch.profiler trace of the
    block, exported as Chrome trace JSON."""
    import json

    import torch

    from vote_saver_tpu_torch.utils.profiling import device_trace

    with device_trace(None):
        pass
    path = tmp_path / "trace.json"
    with device_trace(str(path)):
        torch.ones(64).add_(1)
    assert "traceEvents" in json.loads(path.read_text())
