#!/usr/bin/env python3
"""Write tests/golden/torch_slice_d2.json: depth-2 ballots from the JAX package.

Runs the JAX reference on the CPU (``JAX_PLATFORMS=cpu``, 32-bit limbs,
``VSTPU_HOST_WITNESS=1``: host witness, device-layout prover, host tail)
over the committed election in ``tests/.election_cache/d2_v3.pkl`` for
voters [0, 1, 2] with votes [5, 5, 17] under ``FrRandom(SEED)``, and writes
the hex of each ballot's (proof, pinput, ct, sn) blobs.  ``chip_smoke.py``
holds the PyTorch port's ballots on the GPU to these bytes.

    python scripts/make_torch_golden.py
"""

import json
import os
import pathlib
import pickle
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["VSTPU_LIMB_BITS"] = "32"
os.environ["VSTPU_HOST_WITNESS"] = "1"

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 0x7041D2
VOTERS = [0, 1, 2]
VOTES = [5, 5, 17]
SOURCE = "tests/.election_cache/d2_v3.pkl"
OUT = ROOT / "tests" / "golden" / "torch_slice_d2.json"


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vote_saver_tpu.protocol import phases
    from vote_saver_tpu.utils.rng import FrRandom

    e = pickle.loads((ROOT / SOURCE).read_bytes())
    ctx = phases.prepare_vote_context(
        2, 64, e["tree"], e["rt"], e["eid"], e["pk_eid"], e["pk_crs"], e["vk_crs"]
    )
    ballots = phases.vote_with_context(
        ctx, VOTERS, VOTES, [e["voters"][i][1] for i in VOTERS], FrRandom(SEED)
    )
    for b in ballots:
        assert phases.verify_ballot(b[0], b[1], b[2], e["vk_eid"], e["vk_crs"])
    doc = {
        "source": SOURCE,
        "tree_depth": 2,
        "eid_bits": 64,
        "seed": SEED,
        "voters": VOTERS,
        "votes": VOTES,
        "ballots": [dict(zip(("proof", "pinput", "ct", "sn"), (x.hex() for x in b))) for b in ballots],
    }
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
