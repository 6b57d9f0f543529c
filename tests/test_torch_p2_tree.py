"""K1's subtree entry (ops/poseidon2_cuda.tree_layers) on the CPU, where it
takes its plain twin (ops/poseidon2_plain.tree_layers: one compression a
layer, then every layer out of Montgomery form), against the JAX package.
Bit-exact; inputs from numpy seeds.  (tests/test_torch_p2_tree_stream.py
holds the streaming build that calls it against the oracle.)

One JAX tree_reduce_layers call (it compiles for some ten seconds here):
one tree of 64 Montgomery leaves with key 1 at depths 0 and 3, each layer
then out of Montgomery form by JAX's from_mont.  Every case of the entry is
a piece of that stack: widths 2 to 64 from its layers at their depths,
1, 2, 4 and 8 trees side by side, the key schedule (0,) (the levels below
depth 3) and (0, 3) from depth offsets 0 to 4, Montgomery and canonical
input.  The kernel itself runs only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold it against this twin there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models import hashing as JH
from codex_storage_proofs_circuits_tpu.ops import limbs as JL
from codex_storage_proofs_circuits_tpu_torch.models import hashing as TH
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as TC

BOTTOM = (0, 3)


@pytest.fixture(scope="module")
def jax_stack():
    """(Montgomery layers, canonical layers) of JAX's tree over 64 leaves."""
    rng = np.random.default_rng(64)
    leaves = rng.integers(0, 1 << 16, (16, 64), dtype=np.uint32)
    leaves[15] = rng.integers(0, 0x3064, 64)  # below P
    mont = JH.tree_reduce_layers(jnp.asarray(leaves), BOTTOM)
    # one from_mont over the joined layers: one shape for JAX to compile
    canon = np.asarray(JL.from_mont(jnp.concatenate(mont, axis=1)))
    canon = np.split(canon, np.cumsum([x.shape[1] for x in mont])[:-1], axis=1)
    return ([torch.from_numpy(np.asarray(x).astype(np.int32)) for x in mont],
            [torch.from_numpy(x.astype(np.int32)) for x in canon])


# (depth of the input layer, nodes taken from its start, trees side by side,
# levels, key bits, Montgomery input)
CASES = [
    (0, 64, 1, 6, TH.key_bits(BOTTOM, 6), True),  # the whole tree, (0, 3)
    (0, 64, 8, 3, TH.key_bits((0,), 3), True),  # eight trees of 8, (0,)
    (0, 32, 4, 3, TH.key_bits((0,), 3), False),  # four trees of 8, canonical in
    (1, 32, 1, 5, TH.key_bits(BOTTOM, 5, 1), True),  # depth offset 1
    (1, 32, 2, 4, TH.key_bits(BOTTOM, 4, 1), False),  # two trees of 16
    (2, 16, 4, 2, TH.key_bits(BOTTOM, 2, 2), True),  # four trees of 4, offset 2
    (2, 16, 1, 4, TH.key_bits(BOTTOM, 4, 2), False),
    (3, 8, 1, 3, TH.key_bits(BOTTOM, 3, 3), True),  # key 1 on the first level
    (4, 4, 2, 1, TH.key_bits(BOTTOM, 1, 4), False),
    (4, 4, 1, 2, 0, True),
    (5, 2, 1, 1, 0, False),
]


@pytest.mark.parametrize("depth, nodes, trees, levels, key_bits, mont", CASES)
def test_subtree_entry_matches_jax(jax_stack, depth, nodes, trees, levels, key_bits, mont):
    mont_layers, canon = jax_stack
    src = mont_layers if mont else canon
    got = TC.tree_layers(src[depth][:, :nodes], levels, key_bits, trees, mont)
    assert len(got) == levels + 1 and got[-1].shape == (16, trees)
    for j, lyr in enumerate(got):
        assert torch.equal(lyr, canon[depth + j][:, : nodes >> j]), (depth, j)


def test_tree_reduce_layers_keeps_the_jax_montgomery_api(jax_stack):
    # the one-layer path the subtree entry replaced on the main path: JAX's
    # Montgomery layers, one compression launch a layer
    mont_layers, _ = jax_stack
    got = TH.tree_reduce_layers(mont_layers[0], BOTTOM)
    assert len(got) == len(mont_layers)
    assert all(torch.equal(a, b) for a, b in zip(got, mont_layers))


def test_subtree_entry_refuses_a_width_that_is_not_its_trees():
    with pytest.raises(ValueError):
        TC.tree_layers(torch.zeros((16, 12), dtype=torch.int32), 2, 0, 2)
