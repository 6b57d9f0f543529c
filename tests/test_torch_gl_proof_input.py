"""The port's Goldilocks proof inputs (models/gl_proof_input.py), the
`cspc-torch` CLI on the default field, the pieces the slot build shares
with them (file-backed streaming, single-block slots, the dataset tree) and
the GL state carried across by convert.py, against the JAX package's oracle,
for both hashes.

All comparisons are bit-exact.  The port runs its plain torch versions
here (device="cpu").
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import dataclasses

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.ops.goldilocks_pallas import RC_TABLE
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    calc_slot_tree_gl,
    check_proof_input_gl,
    export_proof_input_gl,
    generate_proof_input_gl,
)
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.models import gl_proof_input as TGPI
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TG
from codex_storage_proofs_circuits_tpu_torch.utils import cli

HASHES = ("poseidon2", "monolith")
GLOB = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)


@pytest.mark.parametrize("hash_fun", HASHES)
@pytest.mark.parametrize("n_slots", [1, 3])
def test_proof_inputs_match_oracle(hash_fun, n_slots):
    # nSlots=1 exercises the singleton dataset fix-up, 3 an odd slot count
    dset = DataSetConfig(n_slots=n_slots, n_cells=32, n_samples=3,
                         data_src=DataSource("fake", seed=12345))
    entropy = OG.int_to_digest(1234567)
    slot = n_slots - 1
    want = dataclasses.asdict(generate_proof_input_gl(hash_fun, GLOB, dset, slot, entropy))
    got = TGPI.generate_proof_input_gl(hash_fun, GLOB, dset, slot, entropy, device="cpu")
    assert dataclasses.asdict(got) == want
    check_proof_input_gl(hash_fun, GLOB, got)
    got = TGPI.generate_proof_input_gl_streaming(hash_fun, GLOB, dset, slot, entropy,
                                                 chunk_cells=16, device="cpu")
    assert dataclasses.asdict(got) == want


@pytest.mark.parametrize("hash_fun", HASHES)
def test_cli_writes_the_oracles_json(hash_fun, tmp_path):
    flags = ["--depth=16", "--maxslots=16", "--cellsize=64", "--blocksize=256", "--nslots=3",
             "--ncells=16", "--nsamples=3", "--seed=777", "--entropy=99", "--index=2",
             f"--hash={hash_fun}"]
    ours, theirs = tmp_path / "torch.json", tmp_path / "oracle.json"
    assert cli.main(flags + ["--device=cpu", "--check", f"--output={ours}"]) == 0
    glob, dset = cli.configs_from_args(cli.build_parser().parse_args(flags))
    export_proof_input_gl(str(theirs), generate_proof_input_gl(
        hash_fun, glob, dset, 2, OG.int_to_digest(99)))
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("hash_fun", HASHES)
def test_streaming_file_backed_slot_matches_oracle(hash_fun, tmp_path):
    path = tmp_path / "slot.dat"
    path.write_bytes(np.random.default_rng(9).integers(0, 256, 32 * 64, np.uint8).tobytes())
    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                     data_src=DataSource("file", filename=str(path)))
    root = TS.streaming_slot_root_gl(cfg, hash_fun, chunk_cells=16, device="cpu")
    assert root == calc_slot_tree_gl(hash_fun, cfg).root


@pytest.mark.parametrize("hash_fun", HASHES)
def test_single_block_slot_gets_the_bottom_odd_compression(hash_fun):
    # the batched stack of a single-block slot: the block's mini-tree, then
    # the big tree over its one root, which is that root's bottom-odd
    # compression
    cfgs = [SlotConfig(cell_size=64, block_size=256, n_cells=4, n_samples=1,
                       data_src=DataSource("fake", seed=s)) for s in (3, 4)]
    stacks = TGH.batched_slot_layers_gl(hash_fun, cfgs, "cpu")
    btd = 2
    for cfg, stack in zip(cfgs, stacks):
        want = calc_slot_tree_gl(hash_fun, cfg)
        got = [TGH.digests(lyr) for lyr in stack]
        assert got[-1] == [want.root]
        assert len(want.mini_trees) == 1 and len(want.big_tree.layers) == 2
        assert got[: btd + 1] == [list(lyr) for lyr in want.mini_trees[0].layers]
        assert got[btd:] == [list(lyr) for lyr in want.big_tree.layers]


@pytest.mark.parametrize("width", [1, 5, 6])
def test_tree_reduce_general_matches_oracle(width):
    rng = np.random.default_rng(width)
    leaves = [tuple(int(v) for v in rng.integers(0, OG.P_GL, 4, dtype=np.uint64))
              for _ in range(width)]
    planes = torch.stack([TG.pack([d[i] for d in leaves]) for i in range(4)])
    layers = TGH.gl_tree_reduce_general(planes, "monolith")
    assert [TGH.digests(lyr) for lyr in layers] == [
        list(lyr) for lyr in merkle_tree(leaves, OG.compress_fn("monolith")).layers
    ]


def test_gl_tables_from_the_jax_kernel_table_equal_the_ports():
    tables = convert.gl_tables_from_numpy(RC_TABLE)
    assert tables.keys() == TG.TABLES.keys()
    for name, t in tables.items():
        assert torch.equal(t, TG.TABLES[name]), name
    with pytest.raises(ValueError):
        convert.gl_tables_from_numpy(RC_TABLE[:, :64])
