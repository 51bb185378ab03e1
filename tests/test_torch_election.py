"""The chain-orchestrated election (``vote_saver_tpu_torch.run_election``) on
the CPU: depth 2, 3 voters, every artifact through the in-memory contracts.

As in ``test_torch_vote.py``, the five MSMs are the native host MSM lifted
to device coordinates and the ballot tail its host oracle (their plain
versions take tens of minutes for one depth-2 batch here); setup runs
host-native on the CPU, as ``run_election.run`` does there.  Every ballot
must pass the voter contract's VERGRTH16 (status 0), the committed tally's
counts must equal the votes, and the observer must accept the tally.
"""

from vote_saver_tpu_torch import run_election, testing
from vote_saver_tpu_torch.params import MSG_SIZE
from vote_saver_tpu_torch.protocol import ballot_dev, groth16
from vote_saver_tpu_torch.testing import torch_threads

from test_torch_vote import _host_msms


def test_run_election_accepts_every_ballot(monkeypatch, capsys):
    monkeypatch.setattr(groth16, "prove_msms", _host_msms)
    monkeypatch.setattr(ballot_dev, "finalize_ballots_device", testing.host_tail)
    with torch_threads(4):
        out = run_election.run(tree_depth=2, voters=3, seed=11, device="cpu")
    assert out["status"] == [0, 0, 0]
    assert out["counts"] == [1, 1, 1] + [0] * (MSG_SIZE - 3)
    assert out["verified"] is True
    log = capsys.readouterr().out
    assert "observer verification: True" in log and log.count("accepted=True (status 0)") == 3
