"""The subtree entry (ops/goldilocks_cuda.tree_layers, whose plain version
ops/goldilocks_plain.tree_layers runs here on the CPU) and the Goldilocks
tree reducer over it (models/gl_hashing.gl_tree_reduce_layers) against the
pure-Python oracle's keyed compressions, for both hashes; and the
frequency-domain form of Monolith's Concrete that the CUDA kernels run
(kernels/build.concrete_tables), applied by the kernel's steps in Python
integers, against the Concrete matrix.  The JAX parity of the same entries
is in tests/test_torch_gl_tree_jax.py.  All comparisons are bit-exact.
"""

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu_torch.fields import goldilocks as G
from codex_storage_proofs_circuits_tpu_torch.kernels import build as B
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as TGC
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TGP
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks as GO

HASHES = ("poseidon2", "monolith")
P = G.P_GL
EDGES = (0, 1, (1 << 32) - 1, P - 1, (1 << 64) - 1)


def _layer(rng, w: int) -> torch.Tensor:
    """w random canonical digests as a (4, 4, w) limb-plane layer."""
    vals = rng.integers(0, P, (4, w), dtype=np.uint64)
    return torch.stack([TGP.pack([int(v) for v in lane]) for lane in vals])


def _oracle_layers(hash_fun: str, layer: torch.Tensor, levels: int, key_bits: int):
    cur = TGH.digests(layer)
    out = []
    for j in range(levels):
        key = (key_bits >> j) & 1
        cur = [GO.compress(hash_fun, key, cur[2 * i], cur[2 * i + 1]) for i in range(len(cur) // 2)]
        out.append(cur)
    return out


@pytest.mark.parametrize("hash_fun", HASHES)
def test_subtree_layers_match_the_oracle(hash_fun):
    rng = np.random.default_rng(61)
    # one tree of 64 digests, key 1 at depths 0 and 2 from a depth offset of
    # 1; then 2 and 4 trees side by side (each a root of its own)
    for w, stop, offset, bottom in ((64, 1, 1, (0, 2)), (32, 2, 0, (0, 3)), (32, 4, 3, (0, 3))):
        layer = _layer(rng, w)
        levels = (w // stop).bit_length() - 1
        key_bits = sum(1 << j for j in range(levels) if offset + j in bottom)
        want = _oracle_layers(hash_fun, layer, levels, key_bits)
        got = TGC.tree_layers(layer, hash_fun, levels, key_bits, stop)
        assert [TGH.digests(lyr) for lyr in got] == want
        reduced = TGH.gl_tree_reduce_layers(layer, hash_fun, bottom, depth_offset=offset,
                                            stop_width=stop)
        assert reduced[0] is layer and len(reduced) == levels + 1
        assert all(torch.equal(a, b) for a, b in zip(reduced[1:], got))
        assert reduced[-1].shape == (4, 4, stop)


def test_subtree_refusals():
    layer = torch.zeros((4, 4, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="not 3 trees of 2\\^2"):
        TGC.tree_layers(layer, "poseidon2", 2, 0, 3)  # 24 digests are 3 trees of 8
    with pytest.raises(ValueError, match="power-of-two trees"):
        TGH.gl_tree_reduce_layers(layer, "poseidon2", (0,), stop_width=1)
    assert TGC.tree_layers(layer, "monolith", 0, 0, 24) == []


def _concrete(x):
    return [sum(m * v for m, v in zip(row, x)) % P for row in G.MONOLITH_CONCRETE]


def test_concrete_form_matches_the_matrix():
    tables = B.concrete_tables(G.MONOLITH_CONCRETE)
    # shifts only, for this matrix
    assert all(abs(v) & (abs(v) - 1) == 0 for k in ("k1", "km", "kr", "ki") for v in tables[k])
    rng = np.random.default_rng(62)
    states = [[e] * 12 for e in EDGES]
    states += [[int(v) for v in rng.choice(EDGES, 12)] for _ in range(20)]
    states += [[int(v) for v in rng.integers(0, 1 << 64, 12, dtype=np.uint64)] for _ in range(50)]
    for x in states:
        assert B.concrete_apply(tables, x) == _concrete(x)
    assert B.concrete_apply(tables, states[-1]) == GO._concrete([v % P for v in states[-1]])


def test_header_refuses_a_concrete_that_is_not_a_circulant(monkeypatch):
    m = [list(row) for row in G.MONOLITH_CONCRETE]
    m[3][5], m[3][6] = m[3][6], m[3][5]
    monkeypatch.setattr(G, "MONOLITH_CONCRETE", tuple(tuple(r) for r in m))
    with pytest.raises(ValueError, match="not a circulant plus a diagonal"):
        B.gl_constants_header()
    identity = tuple(tuple(int(r == c) for c in range(12)) for r in range(12))
    monkeypatch.setattr(G, "MONOLITH_CONCRETE", identity)  # a circulant, but not integral
    with pytest.raises(ValueError, match="not integral"):
        B.gl_constants_header()
