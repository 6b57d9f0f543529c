"""The subtree entry's plain version, through the port's tree reducer
(models/gl_hashing.gl_tree_reduce_layers), against JAX
parallel/gl_tree.gl_tree_reduce_layers with Poseidon2-GL: one tree of 8
digests with key 1 at depths 1 and 3 from a depth offset of 1, through
goldilocks_jnp (an eager compression takes some seconds on a CPU, so this
file holds this one test, on 8 digests; Monolith, on 16:
tests/test_torch_gl_tree_jax.py).
Bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from codex_storage_proofs_circuits_tpu.parallel import gl_tree as JGT
from codex_storage_proofs_circuits_tpu_torch.fields import goldilocks as G
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TGP

HASH = "poseidon2"


def _planes(rng, n: int, w: int) -> np.ndarray:
    """n x w random canonical felts as (n, 4, w) uint32 limb planes."""
    vals = rng.integers(0, G.P_GL, (n, w), dtype=np.uint64)
    return np.stack([TGP.pack([int(v) for v in row]).numpy() for row in vals]).astype(np.uint32)


def _equal(got: list[torch.Tensor], want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(g.numpy(), np.asarray(w).astype(np.int32)) for g, w in zip(got, want))


def test_tree_reducer_matches_jax():
    layer = _planes(np.random.default_rng(71), 4, 8)
    want = JGT.gl_tree_reduce_layers(jnp.asarray(layer), HASH, (1, 3), depth_offset=1)
    got = TGH.gl_tree_reduce_layers(torch.from_numpy(layer.astype(np.int32)), HASH, (1, 3),
                                    depth_offset=1)
    assert len(got) == 4 and _equal(got, want)
