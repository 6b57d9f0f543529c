"""Entry points: the single-device step and the multi-device dry run.

The twins of the repository's __graft_entry__.py (entry, dryrun_multichip)
for the port.  Both run on the card unless the caller names other devices.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): one step of the flagship pipeline, a full BN254
    slot-tree build from encoded cells to every Merkle layer (cell hashes,
    depth-5 block trees, slot tree) of 256 cells of 2048 bytes; fn returns
    the slot root's (16, 1) limb planes."""
    from .models.data import gen_fake_cells
    from .models.hashing import slot_tree_from_felts
    from .ops.encode import encode_cells
    from .parallel.mesh import cuda_devices

    if torch.device(device).type == "cuda":
        cuda_devices()  # raises without a card
    n_cells, cell_size, block_tree_depth = 256, 2048, 5
    cells = gen_fake_cells(cell_size, 12345, np.arange(n_cells))
    felts = encode_cells(torch.from_numpy(cells)).to(device)

    def fn(felts):
        return slot_tree_from_felts(felts, block_tree_depth)[-1]

    return fn, (felts,)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The full sharded dataset build and proof inputs over an n_devices
    mesh, checked against the oracle (raises on any difference).

    Slots on the outer mesh axis, cells on the inner one (each shard's
    subtree, the frontier gathered, the top layers on the row's device),
    then the odd-width dataset tree; both fields; the BN254 and GL proof
    inputs with sampling on the device and path gathers from the sharded
    layers, each held to the oracle and to the circuit's semantics.
    devices: the mesh's devices (default: the CUDA cards in turn, so one
    card holds every shard).  Returns what was built and from what: the
    slot configs `cfgs` and the two dataset roots, `glob`, `dset`,
    `slot_index`, `entropy` and the two proof inputs.
    """
    from .models.circuit import check_circuit_semantics
    from .models.data import gen_fake_cells
    from .models.gl_hashing import digests, encode_cells_gl
    from .models.witness import evaluate_witness, generate_witness
    from .ops import limbs as L
    from .ops.encode import encode_cells
    from .oracle.dataset import DataSetConfig, GlobalConfig
    from .oracle.goldilocks import compress_fn
    from .oracle.goldilocks_pipeline import (
        calc_slot_tree_gl,
        check_proof_input_gl,
        generate_proof_input_gl,
    )
    from .oracle.merkle import merkle_tree
    from .oracle.sampling import generate_proof_input
    from .oracle.slot import DataSource, SlotConfig, calc_slot_tree
    from .parallel import (
        make_mesh,
        sharded_dataset_build,
        sharded_gl_dataset_build,
        sharded_gl_proof_input,
        sharded_proof_input,
    )
    from .parallel.mesh import cuda_devices

    if devices is None:
        cards = cuda_devices()
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): {len(devices)} devices given")
    n_slot_shards = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_cells_shards = n_devices // n_slot_shards
    mesh = make_mesh(n_cells_shards=n_cells_shards, n_slot_shards=n_slot_shards,
                     devices=devices[:n_devices])

    cell_size, block_size = 64, 128
    n_cells = 4 * n_cells_shards
    n_slots = max(2 * n_slot_shards - 1, 1)  # an odd count: the odd dataset tree
    n_slots_padded = -(-n_slots // n_slot_shards) * n_slot_shards
    cfgs = [
        SlotConfig(cell_size=cell_size, block_size=block_size, n_cells=n_cells, n_samples=1,
                   data_src=DataSource("fake", seed=100 + k))
        for k in range(n_slots)
    ]
    cells = [torch.from_numpy(gen_fake_cells(cell_size, cfgs[min(k, n_slots - 1)].data_src.seed,
                                             np.arange(n_cells)))
             for k in range(n_slots_padded)]
    btd = 1  # cells_per_block = 2
    _, _, dlayers = sharded_dataset_build(torch.stack([encode_cells(c) for c in cells]), mesh,
                                          btd, n_slots=n_slots)
    want = merkle_tree([calc_slot_tree(c).root for c in cfgs]).root
    got = L.unpack(dlayers[-1])[0]
    if got != want:
        raise AssertionError(f"dataset root mismatch in dryrun: {hex(got)} != {hex(want)}")
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} dataset root OK")

    gfelts = torch.stack([encode_cells_gl(c.numpy()) for c in cells])
    _, _, gdlayers = sharded_gl_dataset_build(gfelts, mesh, "poseidon2", btd, n_slots=n_slots)
    gwant = merkle_tree([calc_slot_tree_gl("poseidon2", c).root for c in cfgs],
                        compress_fn("poseidon2")).root
    ggot = digests(gdlayers[-1])[0]
    if ggot != gwant:
        raise AssertionError(f"GL dataset root mismatch in dryrun: {ggot} != {gwant}")
    print(f"dryrun_multichip({n_devices}): goldilocks dataset root OK")

    glob = GlobalConfig(max_depth=12, max_log2_n_slots=5, cell_size=cell_size,
                        block_size=block_size)
    dset = DataSetConfig(n_slots=n_slots, n_cells=n_cells, n_samples=3,
                         data_src=DataSource("fake", seed=12345))
    slot_idx, entropy = n_slots - 1, 0xDEADBEEF
    pi = sharded_proof_input(glob, dset, slot_idx, entropy, mesh)
    if pi != generate_proof_input(glob, dset, slot_idx, entropy):
        raise AssertionError("mesh proof input != oracle")
    evaluate_witness(glob, pi, generate_witness(glob, pi))
    check_circuit_semantics(glob, dset, pi)
    print(f"dryrun_multichip({n_devices}): bn254 proof input OK"
          " (oracle-exact, witness, circuit semantics)")

    ent_gl = (entropy, 1, 2, 3)
    pig = sharded_gl_proof_input("poseidon2", glob, dset, slot_idx, ent_gl, mesh)
    if pig != generate_proof_input_gl("poseidon2", glob, dset, slot_idx, ent_gl):
        raise AssertionError("GL mesh proof input != oracle")
    check_proof_input_gl("poseidon2", glob, pig)
    print(f"dryrun_multichip({n_devices}): goldilocks proof input OK"
          " (oracle-exact, semantics)")
    return dict(cfgs=cfgs, dataset_root=got, gl_dataset_root=ggot, glob=glob, dset=dset,
                slot_index=slot_idx, entropy=entropy, proof_input=pi, proof_input_gl=pig)
