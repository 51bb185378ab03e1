"""The deferred MSM finish and the pipelined vote stream on the CPU.

``groth16.prove_msms(..., defer=True)`` launches the five scheduled MSMs
and hands back a ``finish`` that reads their five doubling-corner flags
with one host read; its outputs must equal ``defer=False``'s, and a flagged
query must take the complete-formula fallback.  ``vote_phase_batch`` and
``vote_with_context_stream`` run the depth-2 election (``tests/golden/
torch_slice_d2.json``, written by the JAX package): the batch API gives the
golden ballots, and the stream gives, batch for batch, what sequential
``vote_with_context`` calls give under one seed.

As in ``test_torch_vote.py``, the depth-2 MSMs are the native host MSM
lifted to device coordinates (the scheduled MSM's plain versions are too
slow there; ``chip_smoke.py`` runs the whole stream on the card), and torch
runs on four intra-op threads.  The ballot tail is its host oracle
(``ballot_dev._finalize_host``, which ``test_torch_ballot.py`` holds the
device tail to, and ``test_torch_vote.py`` runs the device tail itself
against the golden) from the same draws, which keeps the file under two
minutes.
"""

import json
import pathlib
import pickle
import random

import numpy as np
import pytest
import torch

from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.params import R
from vote_saver_tpu_torch.protocol import ballot_dev, groth16, phases
from vote_saver_tpu_torch.refimpl import curves as rc
from vote_saver_tpu_torch.refimpl import jacobian as rj
from vote_saver_tpu_torch.testing import torch_threads
from vote_saver_tpu_torch.utils.rng import FrRandom

from test_torch_vote import _host_msms

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUERIES = ("a", "b1", "b2", "l", "h")


def _key(rnd, a_pts, num_primary: int, n_h: int):
    """A proving key holding only what the MSMs read: the a/b1/b2 queries
    over len(a_pts) wires (b1, b2 random), l over the wires past the
    primary ones, h over n_h random points."""
    def g1(k):
        return [rc.g1_mul(rc.g1_gen, rnd.randrange(1, R)) for _ in range(k)]

    m = len(a_pts)
    return groth16.ProvingKey(
        num_primary=num_primary, num_vars=m, domain=n_h + 1, a_pts=a_pts, b1_pts=g1(m),
        b2_pts=[rc.g2_mul(rc.g2_gen, rnd.randrange(1, R)) for _ in range(m)], h_pts=g1(n_h),
        l_pts=g1(m - num_primary - 1), alpha_g1=None, beta_g1=None, beta_g2=None, delta_g1=None,
        delta_g2=None, coo=None, num_constraints=0,
    )


def _same(outs, other) -> bool:
    return all(torch.equal(x, y) for q in QUERIES for x, y in zip(outs[q], other[q]))


def _host(pk, w, h):
    """The five queries' MSMs on the host, per voter."""
    ni = pk.num_primary + 1
    return {"a": [rj.msm_host(pk.a_pts, r) for r in w], "b1": [rj.msm_host(pk.b1_pts, r) for r in w],
            "b2": [rj.msm_host(pk.b2_pts, r, group="g2") for r in w],
            "l": [rj.msm_host(pk.l_pts, r[ni:]) for r in w], "h": [rj.msm_host(pk.h_pts, r) for r in h]}


def _affine(outs):
    return {q: (co.g2_from_device if q == "b2" else co.g1_from_device)(outs[q]) for q in QUERIES}


def test_deferred_finish_matches_immediate():
    """defer=True returns (finish, w_np); finish() gives the outs of
    defer=False, which are the host MSMs of the same scalars, and w_np is
    the host copy of w_std.  Two voters, 48-bit scalars, a wire at 0."""
    rnd = random.Random(4)
    pk = _key(rnd, [rc.g1_mul(rc.g1_gen, rnd.randrange(1, R)) for _ in range(5)], 1, 3)
    w = [[1, 0] + [rnd.getrandbits(48) for _ in range(3)], [1] + [rnd.getrandbits(48) for _ in range(4)]]
    h = [[rnd.getrandbits(48) for _ in range(3)] for _ in range(2)]
    w_std = lb.ints_to_tensor(w, lb.FR, "cpu", mont=False)
    h_std = lb.ints_to_tensor(h, lb.FR, "cpu", mont=False)
    outs, w_np = groth16.prove_msms(pk, w_std, h_std, window_bits=2)
    finish, w_np2 = groth16.prove_msms(pk, w_std, h_std, window_bits=2, defer=True)
    assert callable(finish) and np.array_equal(w_np, w_np2) and np.array_equal(w_np, lb.from_tensor(w_std))
    assert _same(finish(), outs)
    assert _affine(outs) == _host(pk, w, h)


def test_finish_takes_the_fallback_for_the_flagged_query():
    """The madd doubling corner (one point twice under equal scalars, so
    one bucket lifts it and then adds it again) sets the a query's flag
    only: finish() recomputes that query with complete formulas, counts
    one fallback, and marks each MSM stage in turn."""
    rnd = random.Random(5)
    p = rc.g1_mul(rc.g1_gen, rnd.randrange(1, R))
    pk = _key(rnd, [p, p], 0, 1)
    w, h = [[3, 3]], [[5]]
    timer = groth16.StageTimer("cpu")
    finish, _w_np = groth16.prove_msms(pk, lb.ints_to_tensor(w, lb.FR, "cpu", mont=False),
                                       lb.ints_to_tensor(h, lb.FR, "cpu", mont=False), window_bits=2,
                                       timer=timer, defer=True)
    assert "fallbacks" not in timer.counts
    outs = finish()
    assert timer.counts["fallbacks"] == 1
    assert list(timer.seconds) == ["schedules"] + [f"msm_{q}" for q in QUERIES]
    assert _affine(outs) == _host(pk, w, h) and _affine(outs)["a"] == [rc.g1_mul(p, 6)]


@pytest.fixture(scope="module")
def golden():
    g = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    g["election"] = pickle.loads((ROOT / g["source"]).read_bytes())
    return g


def _blob_args(g):
    e = g["election"]
    return (e["tree"], e["rt"], e["eid"])


def _keys(g):
    e = g["election"]
    return e["pk_eid"], e["pk_crs"], e["vk_crs"]


def _hex(ballots):
    return [[x.hex() for x in b] for b in ballots]


def _golden_hex(g):
    return [[b[k] for k in ("proof", "pinput", "ct", "sn")] for b in g["ballots"]]


# a second, smaller batch: voter 1 votes again, for another candidate
SECOND = ([1], [24])


def _host_tail(pk, spk, gvk, outs, votes, rng):
    """finalize_ballots_device stand-in: its host oracle, from the same
    draws of `rng`."""
    return ballot_dev._finalize_host(pk, spk, gvk, outs, votes, ballot_dev.draw_scalars(len(votes), rng))


@pytest.fixture(scope="module")
def sequential(golden):
    """The golden batch through vote_phase_batch (blobs in, on the CPU),
    then SECOND through vote_with_context with the same rng: the sequential
    ballots the stream must reproduce."""
    mp = pytest.MonkeyPatch()
    mp.setattr(groth16, "prove_msms", _host_msms)
    mp.setattr(ballot_dev, "finalize_ballots_device", _host_tail)
    e = golden["election"]
    sks = [e["voters"][i][1] for i in golden["voters"]]
    rng = FrRandom(golden["seed"])
    try:
        with torch_threads(4):
            first = phases.vote_phase_batch(golden["tree_depth"], golden["eid_bits"], golden["voters"],
                                            golden["votes"], *_blob_args(golden), sks, *_keys(golden), rng,
                                            device="cpu")
            ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], *_blob_args(golden),
                                              *_keys(golden), device="cpu")
            second = phases.vote_with_context(ctx, *SECOND, [e["voters"][1][1]], rng)
    finally:
        mp.undo()
    return first, second


def test_vote_phase_batch_matches_golden(golden, sequential):
    """Blob in, ballots out: the golden's voters and seed give the golden
    ballots (the JAX package's); each verifies."""
    first, second = sequential
    assert _hex(first) == _golden_hex(golden)
    vk_eid, vk_crs = golden["election"]["vk_eid"], golden["election"]["vk_crs"]
    assert all(phases.verify_ballot(b[0], b[1], b[2], vk_eid, vk_crs) for b in first + second)


def test_stream_matches_sequential_calls(golden, sequential, monkeypatch):
    """Two batches through the stream under one seed: byte for byte the
    sequential calls' ballots, the first batch the golden (batch 2 is
    launched before batch 1's tail, and draws nothing from the rng)."""
    monkeypatch.setattr(groth16, "prove_msms", _host_msms)
    monkeypatch.setattr(ballot_dev, "finalize_ballots_device", _host_tail)
    e = golden["election"]
    ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], *_blob_args(golden),
                                      *_keys(golden), device="cpu")
    batches = [(golden["voters"], golden["votes"], [e["voters"][i][1] for i in golden["voters"]]),
               (*SECOND, [e["voters"][1][1]])]
    rng = FrRandom(golden["seed"])
    with torch_threads(4):
        got = list(phases.vote_with_context_stream(ctx, batches, rng))
    assert len(got) == 2
    assert _hex(got[0]) == _golden_hex(golden)
    assert [_hex(b) for b in got] == [_hex(b) for b in sequential]
