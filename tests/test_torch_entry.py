"""The port's entry() (entry.py), the twin of __graft_entry__.entry(): the
same example arguments as the JAX package's entry, and a root equal to the
oracle's.  The JAX step itself is not run here: its jit of the 256-cell
slot-tree build compiles for about a minute on this CPU."""

import numpy as np

import __graft_entry__ as jax_entry
from codex_storage_proofs_circuits_tpu_torch.entry import entry
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig, calc_slot_tree


def test_entry_on_cpu_gives_the_oracle_root():
    fn, (felts,) = entry(device="cpu")
    _, (jax_felts,) = jax_entry.entry()
    assert np.array_equal(felts.numpy().astype(np.uint32), np.asarray(jax_felts))
    root = fn(felts)
    assert tuple(root.shape) == (16, 1)
    cfg = SlotConfig(cell_size=2048, block_size=65536, n_cells=256, n_samples=1,
                     data_src=DataSource("fake", seed=12345))
    assert TL.unpack(root) == [calc_slot_tree(cfg).root]
