"""The subtree entry's plain version, through the port's slot tree
(models/gl_hashing.slot_tree_from_felts_gl), against JAX
models/gl_hashing.slot_tree_from_felts_gl with Poseidon2-GL: 8 one-felt
cells in 2 groups, the port's 2 and 4 trees side by side (the JAX reducer
has no stop width).  The jitted JAX tree compiles each permutation of it
for some seconds on a CPU, so this file holds this one test, on 8 cells
(sponge and two compression layers); Monolith, on 16 cells:
tests/test_torch_gl_tree_jax.py.  Bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from codex_storage_proofs_circuits_tpu.models import gl_hashing as JGH
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


def test_trees_side_by_side_match_jax():
    felts = _planes(np.random.default_rng(72), 1, 8)
    want = JGH.slot_tree_from_felts_gl(HASH, jnp.asarray(felts), 1, n_groups=2)
    t = torch.from_numpy(felts.astype(np.int32))
    assert _equal(TGH.slot_tree_from_felts_gl(HASH, t, 1, n_groups=2), want)
    four = TGH.slot_tree_from_felts_gl(HASH, t, 1, n_groups=4)
    assert len(four) == 2 and _equal(four, want[:2])
