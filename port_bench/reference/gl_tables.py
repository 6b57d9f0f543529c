"""Goldilocks tables derived from fields/goldilocks.py, shared by the CUDA
kernels' generated header (kernels/build.py) and the plain torch versions
(ops/goldilocks_plain.py).  The oracle copy keeps its own SPONGE_IV_GL;
tests/test_torch_goldilocks.py holds the two equal."""

from __future__ import annotations

from . import goldilocks as G

# The sponge's capacity IV, in lane 11: 2^64 + 256 * t + rate (mod p).
SPONGE_IV = ((1 << 64) + 256 * G.T + G.RATE) % G.P_GL


def external_matrix() -> list[list[int]]:
    """The Poseidon2-GL external matrix circ(2*M4, M4, M4) as 12 x 12 ints."""
    return [
        [G.M4[r % 4][c % 4] * (2 if r // 4 == c // 4 else 1) for c in range(G.T)]
        for r in range(G.T)
    ]
