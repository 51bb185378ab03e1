"""The default arm of ``vote_with_context`` on the depth-2 election, byte
for byte against ``tests/golden/torch_slice_d2.json`` (written by the JAX
package): device witness -> ``prove_msms_device`` -> device ballot tail ->
serialization, with the stage marks the timer records.

The five MSMs are the native host MSM here, lifted to device coordinates:
the scheduled MSM's plain versions at depth 2 are too slow for the CPU, and
chip_smoke.py runs the whole arm, MSMs included, on the card.  The NTTs of
the 2^14 domain are the heavy part on the CPU, so this module runs torch on
four intra-op threads.
"""

import json
import pathlib
import pickle

from vote_saver_tpu import native_bridge as nb
from vote_saver_tpu.utils.rng import FrRandom
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import limbs as lb
from vote_saver_tpu_torch.protocol import groth16, phases
from vote_saver_tpu_torch.testing import torch_threads

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _host_msms(pk, w_std, h_std, window_bits=None, timer=None, defer=False, mesh=None):
    """prove_msms stand-in, unsharded (`mesh` None): native host MSMs,
    lifted to device coordinates; (outs, or with defer a zero-arg finish
    giving them, and the host copy of w_std)."""
    assert mesh is None
    w = lb.tensor_to_ints(w_std, lb.FR, mont=False)
    h = lb.tensor_to_ints(h_std, lb.FR, mont=False)
    scal = {"a": w, "b1": w, "b2": w, "l": w[:, pk.num_primary + 1 :], "h": h}
    outs = {}
    for name, s in scal.items():
        pts = getattr(pk, f"{name}_pts")
        group = "g2" if name == "b2" else "g1"
        outs[name] = (co.g2_to_device if name == "b2" else co.g1_to_device)(
            [nb.msm(pts, [int(x) for x in row], group=group) for row in s])
    return ((lambda: outs) if defer else outs), lb.from_tensor(w_std)


def test_default_vote_arm_matches_golden(monkeypatch):
    golden = json.loads((ROOT / "tests" / "golden" / "torch_slice_d2.json").read_text())
    e = pickle.loads((ROOT / golden["source"]).read_bytes())
    ctx = phases.prepare_vote_context(golden["tree_depth"], golden["eid_bits"], e["tree"], e["rt"], e["eid"],
                                      e["pk_eid"], e["pk_crs"], e["vk_crs"], device="cpu")
    monkeypatch.setattr(groth16, "prove_msms", _host_msms)
    timer = groth16.StageTimer("cpu")
    with torch_threads(4):
        ballots = phases.vote_with_context(ctx, golden["voters"], golden["votes"],
                                           [e["voters"][i][1] for i in golden["voters"]],
                                           FrRandom(golden["seed"]), timer=timer)
    assert [[x.hex() for x in b] for b in ballots] == \
        [[g[k] for k in ("proof", "pinput", "ct", "sn")] for g in golden["ballots"]]
    assert list(timer.seconds) == ["witness", "abc_h", "ballot_tail", "serialize"]
    assert set(timer.launches.values()) == {0}  # CPU tensors launch no kernel
