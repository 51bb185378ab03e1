"""The device ballot tail, byte for byte.

``finalize_ballots_device`` (blinding + SAVER encrypt + rerandomize as
batched curve ops) against its host oracle ``_finalize_host`` and against
the host-witness arm's tail (``groth16._blind_and_assemble`` then
``phases._finish_host``), under one seeded ``FrRandom``, on random keys with
the real message size and one infinite MSM output.  The default vote arm
end to end is in tests/test_torch_vote.py.
"""

import random

import numpy as np
import pytest

from vote_saver_tpu.params import MSG_SIZE, R
from vote_saver_tpu.protocol import marshal as M
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu.refimpl import jacobian as rj
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.protocol import ballot_dev, groth16, phases, saver
from vote_saver_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _to_dev(name, pts):
    return (co.g2_to_device if name == "b2" else co.g1_to_device)(pts)


def _ser(ballots):
    return [(M.ser_ct(ct), M.ser_proof(p)) for ct, p in ballots]


def test_device_tail_matches_host_tails():
    rnd = random.Random(71)
    B, n = 2, MSG_SIZE

    def g1p(k):
        return rj.FixedBaseHost(rc.g1_gen, "g1").mul_many([rnd.randrange(1, R) for _ in range(k)])

    def g2p(k):
        return rj.FixedBaseHost(rc.g2_gen, "g2").mul_many([rnd.randrange(1, R) for _ in range(k)])

    pk = groth16.ProvingKey(
        num_primary=2, num_vars=8, domain=8, a_pts=[], b1_pts=[], b2_pts=[], h_pts=[], l_pts=[],
        alpha_g1=g1p(1)[0], beta_g1=g1p(1)[0], beta_g2=g2p(1)[0], delta_g1=g1p(1)[0], delta_g2=g2p(1)[0],
        coo={}, num_constraints=5,
    )
    gvk = groth16.VerificationKey(alpha_g1=pk.alpha_g1, beta_g2=pk.beta_g2, gamma_g2=g2p(1)[0],
                                  delta_g2=pk.delta_g2, ic=g1p(n + 3))
    spk = saver.SaverPublicKey(s_pts=g1p(n), x_psi=g1p(1)[0], y_pts=g1p(n))
    msm_pts = {k: (g2p if k == "b2" else g1p)(B) for k in ("a", "b1", "b2", "l", "h")}
    msm_pts["h"][1] = None  # an infinite MSM output
    outs = {k: _to_dev(k, v) for k, v in msm_pts.items()}
    votes = [3, 17]

    dev = ballot_dev.finalize_ballots_device(pk, spk, gvk, outs, votes, FrRandom(0xD1F))
    oracle = ballot_dev._finalize_host(pk, spk, gvk, outs, votes, ballot_dev.draw_scalars(B, FrRandom(0xD1F)))
    rng = FrRandom(0xD1F)
    proofs = groth16._blind_and_assemble(pk, *(msm_pts[k] for k in ("a", "b1", "b2", "l", "h")), rng)
    prim = np.array([[int(i == v) for i in range(MSG_SIZE)] for v in votes], dtype=object)
    host_arm = phases._finish_host(spk, gvk, pk, proofs, prim, B, rng)
    assert _ser(dev) == _ser(oracle) == _ser(host_arm)
