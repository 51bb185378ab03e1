"""Setup's window sum (K3d as ``FixedBaseTable.mul`` repeats it) against
the JAX package.

``k_window_sum`` (``csrc/curve_kernels.cuh``) sums each output's 32 table
entries in teams of T threads: each thread the balanced subtree of its
32 / T windows by a binary counter over pairs, then log2(T) shuffle rounds.
``window_sum_model`` runs that schedule over ``add_distinct_plain``, and it
must equal the JAX ``FixedBaseTable.mul`` (the Hillis-Steele scan of 5
distinct adds over 32 lanes, of which index 0 is kept) limb for limb, for
one thread an output and for the team size the card runs
(``hopper_field.WINDOW_TEAM``), in G1 and G2, on the special scalars of
``testing.window_scalars``.  The wrapper on CPU tensors is the plain
version (``window_sum_plain``, the gather and the scan) and launches
nothing.
"""

import random
import re

import jax
import numpy as np
import pytest
import torch

from vote_saver_tpu.ops import curve_ops as jco
from vote_saver_tpu.ops import msm as jmsm
from vote_saver_tpu.refimpl import curves as rc
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import _build
from vote_saver_tpu_torch.ops import curve_ops as co
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.testing import torch_threads, window_scalars


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def window_sum_model(g2: bool, table, digits, team: int):
    """k_window_sum's schedule over add_distinct_plain, every thread of
    every team at once: rank r's windows r K .. r K + K - 1 (K = 32 /
    team) as pairs, a binary counter over the pairs that parks the lower
    partial sums and merges two covering as many windows, then the team's
    rounds, rank r (a multiple of 2d) adding rank r + d's sum as q."""
    W = table[0].shape[0]
    K = W // team
    d = torch.as_tensor(digits).to(torch.int64)
    n = d.shape[0]
    rows = torch.arange(W)[:, None]
    # leaves (K, team * n, ...): window rank * K + k of each output, ranks side by side
    leaves = tuple(c[rows, d.T].reshape(team, K, n, *c.shape[2:]).transpose(0, 1).reshape(K, team * n, *c.shape[2:])
                   for c in table)
    add = lambda p, q: hf.add_distinct_plain(g2, p, q)  # noqa: E731
    parked, cur, nxt, merges = [], None, 0, 0
    for _s in range(K - 1):
        if merges == 0:
            p, q = tuple(c[nxt] for c in leaves), tuple(c[nxt + 1] for c in leaves)
            nxt += 2
            merges = ((nxt // 2) & -(nxt // 2)).bit_length() - 1
        else:
            p, q = parked.pop(), cur
            merges -= 1
        cur = add(p, q)
        if merges == 0 and nxt < K:
            parked.append(cur)
    assert nxt == K and not parked
    sums = tuple(c.reshape(team, n, *c.shape[1:]) for c in cur)
    d_ = 1
    while d_ < team:
        summed = add(tuple(c[0::2 * d_] for c in sums), tuple(c[d_::2 * d_] for c in sums))
        sums = tuple(c.clone() for c in sums)
        for c, s in zip(sums, summed):
            c[0::2 * d_] = s
        d_ *= 2
    return tuple(c[0] for c in sums)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_window_sum_schedule_matches_jax(g2):
    group, gen = ("g2", rc.g2_gen) if g2 else ("g1", rc.g1_gen)
    jt = jmsm.FixedBaseTable(gen, group)
    table = convert.fixed_base_table_from_jax(jt.table)
    ks = window_scalars(7 if g2 else 9, random.Random(61 + g2))
    digits = jt.digits(ks)
    ops = jco.g2_ops() if g2 else jco.g1_ops()
    jout = tuple(convert.from_jax_limbs(np.asarray(c)) for c in jax.jit(lambda d: jt.mul(ops, d))(digits))
    for team in sorted({1, hf.WINDOW_TEAM}):
        got = window_sum_model(g2, table, digits, team)
        assert all(torch.equal(a, b) for a, b in zip(got, jout)), team
    # the plain version and the CPU wrapper are the JAX scan too, and launch nothing
    before = dict(hf.launches)
    wrap = hf.g2_window_sum if g2 else hf.g1_window_sum
    for out in (hf.window_sum_plain(g2, table, digits), wrap(table, torch.from_numpy(digits))):
        assert all(torch.equal(a, b) for a, b in zip(out, jout))
    assert hf.launches == before
    from_dev = co.g2_from_device if g2 else co.g1_from_device
    mul = rc.g2_mul if g2 else rc.g1_mul
    assert from_dev(jout) == [mul(gen, k) if k else None for k in ks]


def test_the_kernels_team_is_the_wrappers():
    """The team size the v1 and fold units build (csrc kWindowTeam) is the
    one the wrapper passes by default."""
    src = (_build.CSRC / "curve_kernels.cuh").read_text()
    assert int(re.search(r"constexpr int kWindowTeam = (\d+);", src).group(1)) == hf.WINDOW_TEAM


def test_window_digits_are_checked():
    table = tuple(torch.zeros((32, 256, 12), dtype=torch.int32) for _ in range(3))
    for bad in (256, -1):
        digits = np.zeros((3, 32), np.int32)
        digits[2, 5] = bad
        with pytest.raises(IndexError):
            hf.window_sum_plain(False, table, digits)
        with pytest.raises(IndexError):
            hf.check_window_digits(torch.from_numpy(digits), 256)
