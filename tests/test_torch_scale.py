"""The scale run (``vote_saver_tpu_torch.scale``) on the CPU against the
JAX package.

``scale.run`` at config 1's depth 2, with 4 voters in two batches of 2, on
``device="cpu"``, once through sequential batches and once through the
stream, each from an empty cache: every voter, key, data, ballot,
decryption-proof and result blob equals what the JAX package's phases give
when called in ``scripts/scale_run.py``'s order under the same
``FrRandom(0x5CA1E)`` (the script itself is not run: it writes under
``.bench_cache/``).  The record has the JAX record's keys, and a tampered
ballot makes the run raise.

On the CPU ``scale.run`` sets up through the host-native arm
(``test_torch_setup.py`` holds the device arm to it).  As in
``test_torch_stream.py``, two device stages take stand-ins whose own tests
hold them to the device code: the five MSMs are the native host MSM lifted
to device coordinates, and the ballot tail is its host oracle from the
same draws (``test_torch_ballot.py``, ``test_torch_vote.py``).  The
scheduled MSM's plain versions take many minutes at depth 2 on the CPU;
``chip_smoke.py``'s ``[scale]`` runs the whole path on the card.
"""

import json
import pathlib

import pytest

from test_torch_stream import _host_tail
from test_torch_vote import _host_msms
from vote_saver_tpu.protocol import phases as jphases
from vote_saver_tpu.utils.rng import FrRandom as JaxFrRandom
from vote_saver_tpu_torch import scale
from vote_saver_tpu_torch.protocol import ballot_dev, groth16, phases
from vote_saver_tpu_torch.testing import torch_threads

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG, VOTERS, BATCH, EID_BITS = 1, 4, 2, 64
MODES = ("sequential", "stream")


def _stand_ins(mp):
    mp.setattr(groth16, "prove_msms", _host_msms)
    mp.setattr(ballot_dev, "finalize_ballots_device", _host_tail)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's phases in scale_run.py's order: voters, keys,
    data, the context, the batches, the tally."""
    depth = scale.CONFIGS[CONFIG]["depth"]
    rng = JaxFrRandom(scale.SEED)
    voters = [jphases.init_voter_phase(i, rng) for i in range(VOTERS)]
    keys = jphases.init_admin_phase_generate_keys(depth, EID_BITS, rng)
    data = jphases.init_admin_phase_generate_data(depth, EID_BITS, [v[0] for v in voters], rng)
    pk_crs, vk_crs, pk_eid, sk_eid, vk_eid = keys
    eid, rt, tree = data
    ctx = jphases.prepare_vote_context(depth, EID_BITS, tree, rt, eid, pk_eid, pk_crs, vk_crs)
    votes = [i % 25 for i in range(VOTERS)]
    ballots = []
    for off in range(0, VOTERS, BATCH):
        idx = list(range(off, off + BATCH))
        ballots += jphases.vote_with_context(ctx, idx, [votes[i] for i in idx], [voters[i][1] for i in idx], rng)
    tally = jphases.tally_admin_phase(depth, [b[2] for b in ballots], sk_eid, vk_eid, pk_crs, vk_crs)
    return dict(voter_init=tuple(b for v in voters for b in v), admin_keygen=keys, admin_data=data,
                ballots=ballots, tally=tally)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """scale.run in each mode from its own empty cache, with the blobs its
    phases returned: {mode: (record, cache dir, ballots, tally)}."""
    mp = pytest.MonkeyPatch()
    _stand_ins(mp)
    seen = {}

    def spy(name):
        """phases.<name>, recording each result (each batch of a stream)."""
        fn = getattr(phases, name)
        got = seen.setdefault(name, [])

        def call(*a, **k):
            out = fn(*a, **k)
            if name != "vote_with_context_stream":
                got.append(out)
                return out
            return (got.append(b) or b for b in out)

        mp.setattr(phases, name, call)

    runs = {}
    try:
        with torch_threads(4):
            for mode in MODES:
                seen.clear()
                for name in ("vote_with_context", "vote_with_context_stream", "tally_admin_phase"):
                    spy(name)
                mp.setattr(scale, "CACHE", tmp_path_factory.mktemp(mode))
                rec = scale.run(CONFIG, VOTERS, BATCH, stream=mode == "stream", device="cpu")
                batches = seen["vote_with_context_stream" if mode == "stream" else "vote_with_context"]
                assert len(batches) == VOTERS // BATCH
                runs[mode] = (rec, scale.CACHE / f"scale_d2_v{VOTERS}", [b for got in batches for b in got],
                              seen["tally_admin_phase"][0])
                mp.undo()
                _stand_ins(mp)
    finally:
        mp.undo()
    return runs


def _cached(cache, name):
    n = int((cache / f"{name}.ok").read_text())
    return tuple((cache / f"{name}.{i}").read_bytes() for i in range(n))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step", ("voter_init", "admin_keygen", "admin_data"))
def test_setup_blobs_match_jax(jax_run, port_runs, mode, step):
    """The cached voter keys, admin keys and election data are the JAX
    package's, byte for byte."""
    _rec, cache, _ballots, _tally = port_runs[mode]
    assert _cached(cache, step) == tuple(jax_run[step])


@pytest.mark.parametrize("mode", MODES)
def test_ballots_match_jax(jax_run, port_runs, mode):
    """Both batches' ballots (proof, primary input, ciphertext, sn) are the
    JAX package's, byte for byte."""
    _rec, _cache, ballots, _tally = port_runs[mode]
    assert len(ballots) == VOTERS
    assert [[x.hex() for x in b] for b in ballots] == [[x.hex() for x in b] for b in jax_run["ballots"]]


@pytest.mark.parametrize("mode", MODES)
def test_tally_matches_jax(jax_run, port_runs, mode):
    """The decryption proof and the result blob are the JAX package's."""
    assert port_runs[mode][3] == jax_run["tally"]


@pytest.mark.parametrize("mode", MODES)
def test_record(port_runs, mode):
    """The record has every key of the JAX script's record but its backend
    and device count, the same nine times, and the port's own keys."""
    rec = port_runs[mode][0]
    ref = json.loads((ROOT / "SCALE_r05_cfg2.json").read_text())
    assert set(ref) - {"backend", "devices"} <= set(rec)
    assert set(rec["times_s"]) == set(ref["times_s"])
    assert rec["tally_counts_ok"] is True
    assert (rec["config"], rec["depth"], rec["voters"], rec["batch"]) == (CONFIG, 2, VOTERS, BATCH)
    assert rec["vote_mode"] == mode and rec["device"] == "cpu" and rec["peak_device_bytes"] is None
    assert rec["verified"] == [0, 1, 2, 3]
    assert rec["proofs_per_s"] > 0 and rec["proofs_per_s_steady"] > 0
    # the host-MSM stand-in marks no schedules or MSMs
    assert set(rec["stage_s"]) == {"witness", "abc_h", "ballot_tail", "serialize"}
    # the CPU run launches no kernel: the plain versions run on CPU tensors
    assert rec["vote_launches"] == {}


def test_sample_spreads_as_the_jax_script():
    assert scale._sample(10240, 4) == [0, 2560, 5120, 7680]
    assert scale._sample(3, 4) == [0, 1, 2]
    assert scale._sample(64, [0, 31, 32, 63]) == [0, 31, 32, 63]


def test_tampered_ballot_raises(port_runs, monkeypatch):
    """A ballot carrying another ballot's ciphertext fails its check and
    the run raises.  The run resumes from the sequential run's cache; its
    batches return that run's ballots with voter 0's ciphertext swapped."""
    _rec, cache, ballots, _tally = port_runs["sequential"]
    forged = [list(b) for b in ballots]
    forged[0][2] = ballots[1][2]

    def vote(ctx, idx, votes, sks, rng=None, timer=None, mesh=None):
        return [tuple(forged[i]) for i in idx]

    monkeypatch.setattr(scale, "CACHE", cache.parent)
    monkeypatch.setattr(phases, "vote_with_context", vote)
    with torch_threads(4), pytest.raises(RuntimeError, match=r"verification failed for voters \[0\]"):
        scale.run(CONFIG, VOTERS, BATCH, device="cpu")
