"""Pedersen hashing and the Merkle build on the device path, against the JAX
package and the oracle.

``ops/pedersen_ops.py`` hashes a batch of rows as one gather from window
tables, a halving-tree sum of the window points (``EdwardsOps.add``, K1 on
the card) and one inversion for the affine x (K1's Fermat chain);
``ops/merkle.py`` builds each level of the tree in one such call.  On the
CPU the kernels' plain versions run, and everything here is exact
equality: the window tables against the JAX ``window_tables`` (carried
across by ``convert.window_tables_from_jax``), the digits and digests
against the JAX ``pedersen_ops`` and the ``refimpl`` oracle on rows of 255
and 510 bits (all-zero and all-one rows among them), the trees at depths
1-3 (and a tree of one leaf) against the oracle arm (``device="host"``)
and the JAX ``merkle.build_tree``, and the election data against the JAX
package's.
"""

import numpy as np
import pytest
import torch

from vote_saver_tpu.ops import field_ops as jfo
from vote_saver_tpu.ops import merkle as jmerkle
from vote_saver_tpu.ops import pedersen_ops as jpo
from vote_saver_tpu.protocol import phases as jphases
from vote_saver_tpu_torch import convert
from vote_saver_tpu_torch.ops import hopper_field as hf
from vote_saver_tpu_torch.ops import merkle
from vote_saver_tpu_torch.ops import pedersen_ops as po
from vote_saver_tpu_torch.params import DIGEST_BITS, PUBLIC_KEY_BITS
from vote_saver_tpu_torch.protocol import marshal as M
from vote_saver_tpu_torch.protocol import phases
from vote_saver_tpu_torch.refimpl import pedersen as rpd
from vote_saver_tpu_torch.testing import torch_threads
from vote_saver_tpu_torch.utils.rng import FrRandom


@pytest.fixture(autouse=True, scope="module")
def _setup():
    jfo.fr_ops()  # the JAX 32-bit limb layout needs x64 before its tables are built
    with torch_threads(4):
        yield


def _rows(seed: int, n: int, nbits: int) -> np.ndarray:
    """n seeded rows of nbits bits; row 0 all zeros, row 1 all ones."""
    bits = np.random.default_rng(seed).integers(0, 2, (n, nbits)).astype(np.int32)
    bits[0], bits[1] = 0, 1
    return bits


def _oracle(rows) -> np.ndarray:
    return np.array([rpd.pedersen_hash([int(b) for b in r]) for r in rows], np.uint32)


@pytest.mark.parametrize("num_windows", [85, 170])
def test_window_tables_match_jax(num_windows):
    ours = po.window_tables(num_windows, "cpu")
    theirs = convert.window_tables_from_jax(jpo.window_tables(num_windows))
    assert len(ours) == len(theirs) == 4
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    assert ours[0].shape == (num_windows, 8, 8)
    assert po.window_tables(num_windows, torch.device("cpu")) is ours


@pytest.mark.parametrize("nbits", [PUBLIC_KEY_BITS, 2 * DIGEST_BITS])
def test_bits_to_digits_matches_jax(nbits):
    bits = _rows(nbits, 5, nbits)
    ours = po.bits_to_digits(torch.from_numpy(bits))
    assert np.array_equal(ours.numpy(), np.asarray(jpo.bits_to_digits(bits)))
    assert ours.shape == (5, -(-nbits // 3)) and int(ours[1, 0]) == 7 and int(ours[0].max()) == 0


@pytest.mark.parametrize("nbits", [PUBLIC_KEY_BITS, 2 * DIGEST_BITS])
def test_pedersen_hash_bits_matches_jax_and_the_oracle(nbits):
    bits = _rows(nbits + 1, 5, nbits)
    hf.reset_launches()
    ours = po.pedersen_hash_bits(bits, nbits, device="cpu")
    assert ours.dtype == torch.uint8 and ours.shape == (5, DIGEST_BITS)
    assert not any(hf.launches.values())  # CPU tensors launch no kernel
    theirs = np.asarray(jpo.pedersen_hash_bits(bits, nbits))
    assert np.array_equal(ours.numpy(), theirs)
    assert np.array_equal(ours.numpy(), _oracle(bits))
    with pytest.raises(ValueError, match="bits"):
        po.pedersen_hash_bits(bits[:, :-1], nbits, device="cpu")


def test_chunked_rows_hash_as_one_call(monkeypatch):
    """A level larger than CHUNK_ROWS hashes in pieces, to the same digests."""
    bits = _rows(7, 7, PUBLIC_KEY_BITS)
    whole = po.pedersen_hash_bits(bits, PUBLIC_KEY_BITS, device="cpu")
    monkeypatch.setattr(po, "CHUNK_ROWS", 3)
    assert torch.equal(po.pedersen_hash_bits(bits, PUBLIC_KEY_BITS, device="cpu"), whole)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_build_tree_matches_the_oracle_and_jax(depth):
    """Each level is one device call on the plain versions; the tree (and
    its blob) equals the oracle arm's and the JAX package's."""
    leaves = _rows(20 + depth, max(2, 1 << depth), PUBLIC_KEY_BITS)[: 1 << depth]
    ours = merkle.build_tree(leaves, device="cpu")
    host = merkle.build_tree(leaves, device="host")
    theirs = jmerkle.build_tree(leaves)
    assert [lv.shape for lv in ours] == [(1 << (depth - k), DIGEST_BITS) for k in range(depth + 1)]
    for a, b, c in zip(ours, host, theirs, strict=True):
        assert a.dtype == b.dtype == np.uint32
        assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))
    blob = M.ser_merkle_tree(merkle.flatten_tree(ours))
    assert blob == M.ser_merkle_tree(merkle.flatten_tree(host)) == M.ser_merkle_tree(jmerkle.flatten_tree(theirs))
    with pytest.raises(ValueError, match="power of two"):
        merkle.build_tree(np.zeros((3, PUBLIC_KEY_BITS), np.int32), device="cpu")


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_verify_path_accepts_the_copath_and_rejects_a_flipped_bit(device):
    leaves = _rows(30, 4, PUBLIC_KEY_BITS)
    levels = merkle.build_tree(leaves, device="host")
    rt = merkle.root(levels)
    for idx in (0, 3):
        sibs = merkle.copath(levels, idx)
        assert merkle.verify_path(levels[0][idx], idx, sibs, rt, device=device)
        assert merkle.verify_path(levels[0][idx], idx, sibs, rt, device=device) == \
            jmerkle.verify_path(levels[0][idx], idx, sibs, rt)
    bad = merkle.copath(levels, 2).copy()
    bad[1, 17] ^= 1
    assert not merkle.verify_path(levels[0][2], 2, bad, rt, device=device)
    assert not merkle.verify_path(levels[0][2], 3, merkle.copath(levels, 2), rt, device=device)


def test_election_data_matches_jax():
    """init_admin_phase_generate_data on the CPU: three keys zero-padded to
    a depth-2 tree, the same three blobs as the JAX package's."""
    rng = FrRandom(81)
    pks = [phases.init_voter_phase(i, rng)[0] for i in range(3)]
    ours = phases.init_admin_phase_generate_data(2, 64, pks, FrRandom(82), device="cpu")
    assert ours == jphases.init_admin_phase_generate_data(2, 64, pks, FrRandom(82))
    assert ours == phases.init_admin_phase_generate_data(2, 64, pks, FrRandom(82), device="host")
    with pytest.raises(ValueError, match="do not fit"):
        phases.init_admin_phase_generate_data(1, 64, pks, FrRandom(82), device="cpu")
