"""Child process of tests/test_torch_sharded.py: the JAX package's sharded
functions on the cases pickled at argv[1] (``entry.sharded_cases``), each
under ``jax.jit`` on a virtual 8-device CPU mesh of points 2 x voters 2;
the results, as uint32 limbs, pickled to argv[2].

A process of its own: eager ``shard_map`` runs op by op (minutes for NTT4
and the scheduled MSM), and tracing ``shard_map`` under ``jit`` leaves
state in JAX that breaks the eager ``shard_map`` calls of
tests/test_sharding.py later in the same process.
"""

import os
import pickle
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("VSTPU_LIMB_BITS", "32")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from vote_saver_tpu.ops import curve_ops as jco  # noqa: E402
from vote_saver_tpu.ops import msm as jmsm  # noqa: E402
from vote_saver_tpu.ops import msm_sched as jms  # noqa: E402
from vote_saver_tpu.ops import ntt_mxu as jmxu  # noqa: E402
from vote_saver_tpu.ops.ntt import get_ntt  # noqa: E402
from vote_saver_tpu.parallel import sharded as jsh  # noqa: E402
from vote_saver_tpu_torch import entry  # noqa: E402

POINTS, VOTERS = 2, 2


def _u32(a):
    return np.asarray(a).astype(np.uint32)


def results(mesh, cases: dict) -> dict:
    ntt = get_ntt(entry.NTT_N)
    plan = jmxu.get_plan(entry.NTT4_N, entry.NTT4_KIND)
    out = {"ntt": _u32(jax.jit(lambda x: jsh.sharded_ntt(mesh, ntt, x))(cases["ntt"].astype(np.uint64))),
           "ntt4": _u32(jax.jit(lambda x: jsh.sharded_ntt4(mesh, "points", plan, x))(
               cases["ntt4"].astype(np.uint64)))}
    pts, ks = cases["msm"]
    res = jax.jit(lambda p, d: jsh.sharded_msm(mesh, p, d))(jco.g1_to_device(pts), jmsm.scalars_to_window_digits(ks))
    out["msm"] = tuple(map(_u32, res))
    # sharded_msm_scheduled as the JAX function runs it: its schedules padded by pad_schedules
    pts, ks, _schedules = cases["msm_scheduled"]
    s = len(ks) // POINTS
    scheds = [jms.build_schedule(ks[i * s : (i + 1) * s], entry.SCHED_W, scalar_bits=entry.SCHED_BITS)
              for i in range(POINTS)]
    fn = jsh.sharded_msm_scheduled_fn(mesh, "g1", scheds[0].num_windows, scheds[0].window_bits, scheds[0].num_parts)
    res, excn = jax.jit(fn)(jax.device_put(jms.g1_affine_to_device(pts)), *jsh.pad_schedules(scheds))
    out["msm_scheduled"] = (tuple(map(_u32, res)), int(np.asarray(excn)))
    cts = cases["tally"]
    flat = jco.g1_to_device([p for row in cts for p in row])
    res = jax.jit(lambda c: jsh.sharded_tally(mesh, c))(tuple(c.reshape(len(cts), 3, *c.shape[1:]) for c in flat))
    out["tally"] = tuple(map(_u32, res))
    return out


def main():
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    mesh = jsh.make_mesh(POINTS, VOTERS)
    with mesh:
        out = results(mesh, cases)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
