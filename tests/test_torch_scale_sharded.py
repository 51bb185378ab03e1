"""The scale run on the ranks of a mesh (``scale.py --points 2``) on the
CPU, from an empty cache, with one rank started late.

The ranks read which cached steps resume once, at the start, as rank 0
reads them.  A rank that read the markers itself, after rank 0 had
written one in the same run, would skip that step's draws, hold other
keys and prove another witness: its ciphertexts would differ from rank
0's and the summed proofs would fail rank 0's check.  Here rank 1 starts
only once rank 0 has cached its voters (or after 5 s), and both ranks
give the same ballots, every one of which rank 0 verifies.

``test_torch_scale.py`` holds the unsharded run to the JAX package and
``test_torch_sharded.py`` the sharded vote to the unsharded one; the
ranks run the host stand-ins of the latter (``testing.scale_test_rank``).
"""

from vote_saver_tpu_torch import testing
from vote_saver_tpu_torch.parallel import sharded

CONFIG, VOTERS, BATCH = 1, 4, 2


def test_sharded_run_from_an_empty_cache_keeps_the_ranks_in_step(tmp_path):
    kw = dict(config=CONFIG, voters=VOTERS, batch=BATCH, verify_sample=VOTERS, device="cpu")
    ranks = sharded.spawn(testing.scale_test_rank, (kw, str(tmp_path), 5.0), 2, 1, "cpu", "gloo", timeout=600)
    ballots = [[[x.hex() for x in b] for b in r.value["ballots"]] for r in ranks]
    assert len(ballots[0]) == VOTERS and ballots[1] == ballots[0]
    rec = ranks[0].value["rec"]
    assert rec["mesh"] == "points=2 x voters=1"
    assert rec["verified"] == list(range(VOTERS)) and rec["tally_counts_ok"] is True
    assert "verified" not in ranks[1].value["rec"]
    assert all(r.foreign == [] for r in ranks)
