"""The subtree entry's plain version, through the port's tree reducer and
slot tree (models/gl_hashing.py), against the JAX package, with Monolith:
JAX parallel/gl_tree.gl_tree_reduce_layers on one tree of 16 digests with
key 1 at depths 0 and 2 from a depth offset of 1, and JAX
models/gl_hashing.slot_tree_from_felts_gl on 16 one-felt cells in 2 groups
(the port's 2 and 4 trees side by side: the JAX reducer has no stop
width).  Both JAX calls run through goldilocks_jnp, whose permutations
compile for seconds each on a CPU, so each hash has files of its own
(Poseidon2-GL: tests/test_torch_gl_tree_jax_p2*.py).  Bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from codex_storage_proofs_circuits_tpu.models import gl_hashing as JGH
from codex_storage_proofs_circuits_tpu.parallel import gl_tree as JGT
from codex_storage_proofs_circuits_tpu_torch.fields import goldilocks as G
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TGP

HASH = "monolith"


def _planes(rng, n: int, w: int) -> np.ndarray:
    """n x w random canonical felts as (n, 4, w) uint32 limb planes."""
    vals = rng.integers(0, G.P_GL, (n, w), dtype=np.uint64)
    return np.stack([TGP.pack([int(v) for v in row]).numpy() for row in vals]).astype(np.uint32)


def _equal(got: list[torch.Tensor], want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(g.numpy(), np.asarray(w).astype(np.int32)) for g, w in zip(got, want))


def test_tree_reducer_matches_jax():
    layer = _planes(np.random.default_rng(71), 4, 16)
    want = JGT.gl_tree_reduce_layers(jnp.asarray(layer), HASH, (0, 2), depth_offset=1)
    got = TGH.gl_tree_reduce_layers(torch.from_numpy(layer.astype(np.int32)), HASH, (0, 2),
                                    depth_offset=1)
    assert len(got) == 5 and _equal(got, want)


def test_trees_side_by_side_match_jax():
    felts = _planes(np.random.default_rng(72), 1, 16)
    want = JGH.slot_tree_from_felts_gl(HASH, jnp.asarray(felts), 2, n_groups=2)
    t = torch.from_numpy(felts.astype(np.int32))
    assert _equal(TGH.slot_tree_from_felts_gl(HASH, t, 2, n_groups=2), want)
    four = TGH.slot_tree_from_felts_gl(HASH, t, 2, n_groups=4)
    assert len(four) == 3 and _equal(four, want[:3])
