"""The port's plain Goldilocks ops (ops/goldilocks_plain.py, the plain
version of kernels K4, K5 and K6) against the JAX package's jnp path
(ops/goldilocks_jnp.py, what models/gl_hashing.py runs off the TPU), the
oracle and the frozen vectors, for both hashes.

All comparisons are bit-exact (integers: tolerance 0); inputs are made with
numpy from a seed.  The JAX side runs as the JAX package's own CPU tests run
it, through goldilocks_jnp (tests/test_gl_pallas.py records that the Pallas
kernel's interpret mode takes minutes to compile the unrolled permutation).
Each jnp permutation compiles its round scans anew on every call, so the
JAX calls here are few and batched.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.ops import goldilocks_jnp as GJ
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu_torch.fields import gl_tables as GT
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TG

HASHES = ("poseidon2", "monolith")
P = OG.P_GL
EDGE = [0, 1, P - 1, P, (1 << 64) - 1, 1 << 32, (1 << 32) - 1]
VEC = json.load(open(pathlib.Path(__file__).parent / "vectors" / "gl_testvectors.json"))


def _planes(values_by_lane) -> np.ndarray:
    """[lane][column] python ints -> (lanes, 4, B) uint32 limb planes."""
    return np.stack([TG.pack(vals).numpy().astype(np.uint32) for vals in values_by_lane])


def _ints(planes) -> list[list[int]]:
    """(lanes, 4, B) limb planes -> [column][lane] python ints."""
    t = torch.as_tensor(np.asarray(planes).astype(np.int64))
    lanes = [TG.unpack(t[i]) for i in range(t.shape[0])]
    return [list(col) for col in zip(*lanes)]


def test_add_and_mul_on_the_loose_edge_family():
    a = [x for x in EDGE for _ in EDGE]
    b = [y for _ in EDGE for y in EDGE]
    ta, tb = TG.pack(a), TG.pack(b)
    got_add, got_mul = TG.unpack(TG.gl_add(ta, tb)), TG.unpack(TG.gl_mul(ta, tb))
    assert got_add == [(x + y) % P for x, y in zip(a, b)]
    assert got_mul == [x * y % P for x, y in zip(a, b)]
    ja, jb = jnp.asarray(ta.numpy().astype(np.uint32)), jnp.asarray(tb.numpy().astype(np.uint32))
    assert got_add == GJ.unpack(GJ.gl_add(ja, jb))
    assert got_mul == GJ.unpack(GJ.gl_mul(ja, jb))


def _states(rng, b: int) -> list[list[int]]:
    """b states of 12 lanes: the KAT [0..11], the loose edge family, random."""
    states = [list(range(12)), (EDGE * 2)[:12], [(1 << 64) - 1] * 12]
    while len(states) < b:
        states.append([int(v) for v in rng.integers(0, 1 << 64, 12, dtype=np.uint64)])
    return states


@pytest.mark.parametrize("hash_fun", HASHES)
def test_permutation_matches_jnp_and_oracle(hash_fun):
    states = _states(np.random.default_rng(11), 8)
    planes = _planes([[s[i] for s in states] for i in range(12)])
    named = {"poseidon2": TG.poseidon2_gl_permutation, "monolith": TG.monolith_permutation}
    got = named[hash_fun](torch.from_numpy(planes.astype(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (12, 4, 8)
    want = GJ.PERMUTATIONS[hash_fun](jnp.asarray(planes))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert _ints(got.numpy()) == [OG.PERMUTATIONS[hash_fun](s) for s in states]


@pytest.mark.parametrize("hash_fun", HASHES)
def test_compress_matches_jnp_and_oracle_for_every_key(hash_fun):
    rng = np.random.default_rng(12)
    x = [tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64)) for _ in range(8)]
    y = [tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64)) for _ in range(8)]
    xp, yp = _planes(list(zip(*x))), _planes(list(zip(*y)))
    keys = [k % 4 for k in range(8)]  # one jnp call: the key as a (4, B) plane
    key_plane = jnp.asarray(TG.pack(keys).numpy().astype(np.uint32))
    want = np.asarray(GJ.compress_batch(hash_fun, key_plane, jnp.asarray(xp), jnp.asarray(yp)))
    tx, ty = torch.from_numpy(xp.astype(np.int32)), torch.from_numpy(yp.astype(np.int32))
    for key in range(4):
        got = TG.compress_batch(hash_fun, key, tx, ty).numpy()
        cols = [b for b in range(8) if keys[b] == key]
        assert np.array_equal(got[:, :, cols], want[:, :, cols].astype(np.int32))
        assert [tuple(d) for d in _ints(got)] == [OG.compress(hash_fun, key, a, b)
                                                   for a, b in zip(x, y)]


@pytest.mark.parametrize("hash_fun", HASHES)
def test_sponge_matches_oracle_over_the_padding_edge_and_jnp(hash_fun):
    rng = np.random.default_rng(13)
    for n in (1, 7, 8, 15, 16):
        felts = rng.integers(0, 1 << 62, (3, n), dtype=np.uint64)
        planes = _planes([[int(v) for v in felts[:, i]] for i in range(n)])
        got = TG.sponge_digest_felts(hash_fun, torch.from_numpy(planes.astype(np.int32)))
        assert got.shape == (4, 4, 3)
        assert [tuple(d) for d in _ints(got.numpy())] == [
            OG.digest_felts(hash_fun, [int(v) for v in row]) for row in felts
        ]
        if n == 8:  # the padding fills a whole block of its own
            want = GJ.sponge_digest_felts(hash_fun, jnp.asarray(planes))
            assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("hash_fun", HASHES)
def test_sponge_matches_the_frozen_vectors(hash_fun):
    for n, want in enumerate(VEC[hash_fun]["digest_felts"]):
        planes = _planes([[v] for v in range(1, n + 1)]) if n else np.zeros((0, 4, 1), np.uint32)
        got = TG.sponge_digest_felts(hash_fun, torch.from_numpy(planes.astype(np.int32)))
        assert tuple(_ints(got.numpy())[0]) == tuple(int(s) for s in want), n


def test_tables_and_refusals():
    assert GT.SPONGE_IV == OG.SPONGE_IV_GL
    assert TG.unpack(TG.TABLES["iv"][:, None]) == [OG.SPONGE_IV_GL]
    state = [int(v) for v in np.random.default_rng(14).integers(0, P, 12, dtype=np.uint64)]
    assert [sum(m * v for m, v in zip(row, state)) % P
            for row in GT.external_matrix()] == OG._external_linear(state)
    assert [TG.unpack(TG.TABLES["ext_rc"][r].T) for r in range(8)] == [
        list(row) for row in OG.P2GL_EXTERNAL_RC
    ]
    with pytest.raises(ValueError, match="unknown hash"):
        TG.permutation(torch.zeros((12, 4, 1), dtype=torch.int32), "sha256")
    with pytest.raises(ValueError, match="not \\(12, 4, B\\)"):
        TG.permutation(torch.zeros((4, 4, 1), dtype=torch.int32))
