"""The port's multi-rank layer (``vote_saver_tpu_torch.parallel.sharded``)
against the JAX package's ``parallel.sharded`` on the CPU.

One spawn of 4 gloo ranks, a mesh of points 2 x voters 2, runs every case
(``testing.sharded_test_rank``, a function of the port: a rank imports
nothing of a test module, hence nothing of JAX).  The inputs come from one
seed (``entry.sharded_cases`` at scale 2): ``sharded_msm`` over 16 points,
``sharded_tally`` over 8 x 3 ciphertexts, ``sharded_ntt`` over 4
polynomials of 2^4, ``sharded_ntt4`` at 2^8 and ``sharded_msm_scheduled``
over 32 points with 40-bit scalars at w = 5, each equal limb for limb
(Jacobian, Montgomery) to the JAX function on a virtual 8-device CPU mesh
cut to the same shape (``make_mesh(2, 2)``; each JAX function under
``jax.jit``, in a child process, ``_torch_sharded_jax.py``), and every
rank holding the same result.  ``pad_schedules`` equals the JAX one
without a spawn.  The ranks
at voters coordinate 0 then run ``vote_with_context(mesh=)`` on the
depth-2 election, points sharded in 2, with the scheduled MSMs and the
ballot tail as host stand-ins (``testing.host_msm_device``, which decodes
each shard's schedule back into its scalars, and ``testing.host_tail``):
the ballots are byte for byte the port's unsharded ones under the golden
seed (``tests/golden/torch_slice_d2.json``, which the unsharded vote is
held to in ``test_torch_vote.py``).
"""

import concurrent.futures
import json
import pathlib
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest

from vote_saver_tpu.ops import msm_sched as jms
from vote_saver_tpu.parallel import sharded as jsh
from vote_saver_tpu_torch import entry, testing
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.ops import msm_sched as ms
from vote_saver_tpu_torch.parallel import sharded
from vote_saver_tpu_torch.protocol import phases

ROOT = pathlib.Path(__file__).resolve().parent.parent
POINTS, VOTERS, SEED = 2, 2, 0x5A2D


@pytest.fixture(scope="module")
def golden():
    g = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    g["election"] = pickle.loads((ROOT / g["source"]).read_bytes())
    return g


@pytest.fixture(scope="module")
def cases():
    return entry.sharded_cases(random.Random(SEED), POINTS, VOTERS, scale=2)


def _spawn(cases, golden):
    e = golden["election"]
    ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"],
                                      e["pk_eid"], e["pk_crs"], e["vk_crs"], device="cpu")
    vote_args = (ctx, golden["voters"], golden["votes"], [e["voters"][i][1] for i in golden["voters"]],
                 golden["seed"])
    return sharded.spawn(testing.sharded_test_rank, (cases, vote_args), POINTS, VOTERS, "cpu", "gloo", timeout=900)


def _jax(cases, tmp):
    """The JAX sharded functions' results by case, from a child process
    (``_torch_sharded_jax.py``: each under jax.jit, which must not run in
    this worker, where test_sharding.py may run eagerly after it)."""
    src, dst = tmp / "cases.pkl", tmp / "jax.pkl"
    src.write_bytes(pickle.dumps(cases))
    subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_sharded_jax.py"), str(src), str(dst)], check=True,
                   timeout=900)
    return pickle.loads(dst.read_bytes())


@pytest.fixture(scope="module")
def runs(cases, golden, tmp_path_factory):
    """(the ranks' RankResults, the JAX functions' results by case), both
    at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(_spawn, cases, golden)
        want = pool.submit(_jax, cases, tmp_path_factory.mktemp("sharded"))
        return ranks.result(), want.result()


def test_ranks_agree_and_import_no_jax(runs):
    """Every rank returns the same results (the replicated out_specs=P()),
    launches no kernel on the CPU, and has neither jax nor the JAX package
    in its sys.modules."""
    ranks, _want = runs
    assert all(r.foreign == [] for r in ranks)
    assert all(r.launches == {} for r in ranks)
    assert all(entry._equal(r.value["cases"], ranks[0].value["cases"]) for r in ranks[1:])


@pytest.mark.parametrize("case", ["ntt", "ntt4", "msm", "msm_scheduled", "tally"])
def test_sharded_function_matches_jax(runs, case):
    """The port's sharded function equals the JAX one limb for limb; the
    scheduled MSM's flag count is 0 on both."""
    ranks, want = runs
    assert entry._equal(ranks[0].value["cases"][case], want[case])
    if case == "msm_scheduled":
        assert want[case][1] == 0


def test_pad_schedules_matches_jax():
    """Shards of unequal load (9 and 400 scalars: 16 and 32 schedule rows)
    pad to one (steps, lanes): the stacked codes, merge parts and gathers
    equal the JAX function's."""
    rnd = random.Random(3)
    shards = [[rnd.randrange(1 << 40) for _ in range(n)] for n in (9, 400)]
    raw = [ms.build_schedule(k, 5, scalar_bits=40) for k in shards]
    assert raw[0].codes.shape != raw[1].codes.shape
    ours = sharded.pad_schedules(raw)
    theirs = jsh.pad_schedules([jms.build_schedule(k, 5, scalar_bits=40) for k in shards])
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def test_host_msm_stand_in_decodes_the_schedule():
    """schedule_scalars gives back every part's scalars, orphan lanes
    included, so the vote below sums what each shard's schedule holds."""
    rnd = random.Random(5)
    parts = [[rnd.choice((0, 1, 1, 2)) if i % 5 else rnd.randrange(1 << 250) for i in range(300)] for _ in range(2)]
    sched = ms.build_schedule_multi([lb.ints_to_limbs(p, lb.FR) for p in parts], 6)
    assert sched.merge_gather.any(), "the skewed scalars must spill into orphan lanes"
    assert testing.schedule_scalars(sched) == parts


def test_sharded_vote_matches_unsharded(runs, golden):
    """vote_with_context(mesh=) with the points axis 2: the ballots of both
    ranks of the voters-0 points group equal the unsharded golden ones;
    the ranks of the other group do not vote."""
    want = [[b[k] for k in ("proof", "pinput", "ct", "sn")] for b in golden["ballots"]]
    voted = [r.value["ballots"] for r in runs[0] if "ballots" in r.value]
    assert len(voted) == POINTS
    assert all([[x.hex() for x in b] for b in ballots] == want for ballots in voted)


def test_init_distributed_reads_the_environment(monkeypatch):
    """Without VSTPU_DISTRIBUTED init_distributed does nothing; with the
    four variables it joins their group (here of one gloo rank) and a
    second call leaves that group as it is."""
    import socket

    import torch.distributed as dist

    monkeypatch.delenv("VSTPU_DISTRIBUTED", raising=False)
    assert sharded.init_distributed("gloo") is False and not dist.is_initialized()
    with socket.socket() as s:  # the group's store binds it again at once, in this process
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("VSTPU_DISTRIBUTED", "1")
    monkeypatch.setenv("VSTPU_COORD", f"localhost:{port}")
    monkeypatch.setenv("VSTPU_NPROC", "1")
    monkeypatch.setenv("VSTPU_PROCID", "0")
    try:
        assert sharded.init_distributed("gloo") is True
        assert dist.get_world_size() == 1 and dist.get_rank() == 0 and dist.get_backend() == "gloo"
        assert sharded.init_distributed("gloo") is False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
