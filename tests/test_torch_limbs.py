"""Port limb algebra (torch) against the JAX limb algebra and python ints.

Same inputs (numpy.random.default_rng) go through
codex_storage_proofs_circuits_tpu.ops.limbs and its torch port; results
must be bit-exact (tolerance 0) at B = 64, edge values included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.fields import bn254 as F
from codex_storage_proofs_circuits_tpu.ops import limbs as JL
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL

B = 64
EDGES = [0, 1, F.P - 1, F.R_MONT]  # R_MONT = R mod P


def _felts(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(20240601)
    xs = EDGES + _felts(rng, B - len(EDGES))
    ys = EDGES[::-1] + _felts(rng, B - len(EDGES))
    return xs, ys


def _jax(fn, *planes):
    return np.asarray(jax.jit(fn)(*[jnp.asarray(p, jnp.uint32) for p in planes]))


def test_pack_unpack_matches_jax(operands):
    xs, _ = operands
    t = TL.pack(xs)
    assert t.dtype == torch.int32 and tuple(t.shape) == (16, B)
    assert np.array_equal(t.numpy(), np.asarray(JL.pack(xs)).astype(np.int32))
    assert TL.unpack(t) == xs


@pytest.mark.parametrize(
    "name,oracle",
    [
        ("add_mod", lambda x, y: (x + y) % F.P),
        ("sub_mod", lambda x, y: (x - y) % F.P),
        ("mont_mul", lambda x, y: x * y * F.R_INV % F.P),
    ],
)
def test_binary_op_matches_jax(operands, name, oracle):
    xs, ys = operands
    a, b = TL.pack(xs), TL.pack(ys)
    got = getattr(TL, name)(a, b)
    assert got.dtype == torch.int32
    want = _jax(getattr(JL, name), a.numpy(), b.numpy())
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert TL.unpack(got) == [oracle(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "name,oracle", [("to_mont", F.to_mont), ("from_mont", F.from_mont)]
)
def test_conversion_matches_jax(operands, name, oracle):
    xs, _ = operands
    a = TL.pack(xs)
    got = getattr(TL, name)(a)
    want = _jax(getattr(JL, name), a.numpy())
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert TL.unpack(got) == [oracle(x) for x in xs]


def test_normalize_matches_jax():
    rng = np.random.default_rng(7)
    cols = rng.integers(0, 1 << 22, size=(16, B), dtype=np.int64)
    cols[:, :4] = [[0xFFFF], [0xFFFF], [0x10000], [0]] * 4  # long carry chains
    got = TL.normalize(torch.from_numpy(cols.astype(np.int32)))
    want = _jax(JL.normalize, cols.astype(np.uint32))
    assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_int64_planes_keep_their_dtype(operands):
    xs, ys = operands
    a, b = TL.pack(xs), TL.pack(ys)
    got = TL.mont_mul(a.to(torch.int64), b.to(torch.int64))
    assert got.dtype == torch.int64
    assert torch.equal(got.to(torch.int32), TL.mont_mul(a, b))
