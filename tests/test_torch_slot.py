"""The port's slice as a whole: slot trees, streaming builds, proof inputs
and the `cspc-torch` CLI, against the JAX package and the oracle.

All comparisons are bit-exact.  The JAX slot pipeline runs at one width
(64 cells of 64 bytes, block_tree_depth 2) to bound XLA:CPU compile time.
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.fields import bn254 as F
from codex_storage_proofs_circuits_tpu.models import data as D
from codex_storage_proofs_circuits_tpu.models import hashing as JH
from codex_storage_proofs_circuits_tpu.models.witness import evaluate_witness, generate_witness
from codex_storage_proofs_circuits_tpu.ops import encode as JE
from codex_storage_proofs_circuits_tpu.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input as oracle_pi
from codex_storage_proofs_circuits_tpu.oracle.sampling import sample_cell_index
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig, calc_slot_tree
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as TH
from codex_storage_proofs_circuits_tpu_torch.models import proof_input as TPI
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BTD = 2  # 64-byte cells, 256-byte blocks
SLOT64 = SlotConfig(cell_size=64, block_size=256, n_cells=64, n_samples=1,
                    data_src=DataSource("fake", seed=21))
GLOB = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)


def _oracle_layers(cfg: SlotConfig) -> list[list[int]]:
    """The flat cell -> block -> slot layer stack of the oracle's trees."""
    t = calc_slot_tree(cfg)
    btd = cfg.cells_per_block.bit_length() - 1
    low = [[v for m in t.mini_trees for v in m.layers[d]] for d in range(btd)]
    return low + [list(lyr) for lyr in t.big_tree.layers]


@pytest.fixture(scope="module")
def felts():
    cells = D.load_slot_cells(SLOT64)
    return torch.from_numpy(cells), np.asarray(JE.encode_cells(cells))


@pytest.fixture(scope="module")
def jax_layers(felts):
    _, jfelts = felts
    return [np.asarray(x) for x in JH.slot_tree_from_felts(jnp.asarray(jfelts), BTD)]


def test_slot_tree_every_layer_matches_jax(felts, jax_layers):
    cells, _ = felts
    layers = TH.slot_tree_from_felts(TE.encode_cells(cells), BTD)
    assert len(layers) == len(jax_layers) == 7
    for got, want in zip(convert.layers_to_numpy(layers), jax_layers):
        assert np.array_equal(got, want)
    assert TL.unpack(layers[-1]) == [calc_slot_tree(SLOT64).root]


def test_slot_tree_two_groups_stop_below_the_joint_root(felts, jax_layers):
    # two 32-cell trees side by side: every layer is the joint tree's, the
    # pairing never crosses the group boundary, and the reduction stops at
    # one root per group
    cells, _ = felts
    layers = TH.slot_tree_from_felts(TE.encode_cells(cells), BTD, n_groups=2)
    assert len(layers) == len(jax_layers) - 1
    for got, want in zip(convert.layers_to_numpy(layers), jax_layers):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_slot_tree_from_rows_matches_jax(felts, jax_layers, n_groups):
    # the main path's entry: cell byte rows read in place, K1's subtree
    # entry (its plain twin here) for every layer, canonical out
    cells, _ = felts
    layers = TH.slot_tree_from_rows(cells.T, BTD, n_groups=n_groups)
    assert len(layers) == len(jax_layers) + 1 - n_groups
    for got, want in zip(convert.layers_to_numpy(layers), jax_layers):
        assert np.array_equal(got, want)


def test_extract_paths_device_on_jax_layers(jax_layers):
    idxs = [0, 5, 17, 63]
    want = np.asarray(
        JH.extract_paths_device([jnp.asarray(x) for x in jax_layers], jnp.asarray(idxs), 12)
    )
    layers = convert.layers_from_numpy(jax_layers)
    got = TH.extract_paths_device(layers, torch.tensor(idxs), 12)
    assert np.array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("width", [1, 5, 6])
def test_tree_reduce_general_matches_oracle(width):
    rng = np.random.default_rng(width)
    leaves = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(width)]
    layers = TH.tree_reduce_general(TL.to_mont(TL.pack(leaves)))
    got = [TL.unpack(lyr) for lyr in TH.from_mont_layers(layers)]
    assert got == [list(x) for x in merkle_tree(leaves).layers]


def test_streaming_layers_match_oracle():
    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                     data_src=DataSource("fake", seed=77))
    stats = TS.StreamingStats()
    layers = TS.streaming_slot_layers(cfg, chunk_cells=8, stats=stats, device="cpu")
    assert stats.chunks == 4 and stats.cells == 32
    assert [TL.unpack(lyr) for lyr in layers] == _oracle_layers(cfg)


def test_streaming_file_backed_slot_matches_oracle(tmp_path):
    path = tmp_path / "slot.dat"
    path.write_bytes(np.random.default_rng(9).integers(0, 256, 32 * 64, np.uint8).tobytes())
    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                     data_src=DataSource("file", filename=str(path)))
    root = TS.streaming_slot_root(cfg, chunk_cells=16, device="cpu")
    assert root == calc_slot_tree(cfg).root


def test_streaming_single_chunk_degenerates():
    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=16, n_samples=1,
                     data_src=DataSource("fake", seed=3))
    root = TS.streaming_slot_root(cfg, chunk_cells=64, device="cpu")  # clamped
    assert root == calc_slot_tree(cfg).root


@pytest.mark.parametrize(
    "n_slots,n_cells,slot_index",
    [
        (3, 16, 1),  # an odd slot count
        (1, 32, 0),  # nSlots=1: maskBitsCorrected[0]=1 in the dataset path
        (2, 4, 1),  # single-block slots: the extra bottom-odd compression
    ],
)
def test_proof_input_matches_oracle_and_witness(n_slots, n_cells, slot_index):
    dset = DataSetConfig(n_slots=n_slots, n_cells=n_cells, n_samples=3,
                         data_src=DataSource("fake", seed=12345))
    got = TPI.generate_proof_input(GLOB, dset, slot_index, 1234567, device="cpu")
    # the port returns its own oracle copy's ProofInput: compare field by field
    want = oracle_pi(GLOB, dset, slot_index, 1234567)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    evaluate_witness(GLOB, got, generate_witness(GLOB, got))


def test_streaming_proof_input_matches_oracle():
    dset = DataSetConfig(n_slots=2, n_cells=32, n_samples=4,
                         data_src=DataSource("fake", seed=5))
    got = TPI.generate_proof_input_streaming(GLOB, dset, 1, 424242, chunk_cells=16,
                                             device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(oracle_pi(GLOB, dset, 1, 424242))
    evaluate_witness(GLOB, got, generate_witness(GLOB, got))
    bad = dataclasses.replace(got, merkle_paths=[list(p) for p in got.merkle_paths])
    bad.merkle_paths[0][1] ^= 1
    with pytest.raises(AssertionError):
        evaluate_witness(GLOB, bad, generate_witness(GLOB, bad))


@pytest.mark.parametrize("log2n", [1, 5, 19, 32])
def test_device_sampler_matches_the_oracle(log2n):
    rng = np.random.default_rng(log2n)
    entropy, root = (int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(2))
    n_samples = 6
    got = TH.sample_indices(entropy, TL.pack([root]), n_samples, log2n).tolist()
    assert got == [sample_cell_index(entropy, root, 1 << log2n, c)
                   for c in range(1, n_samples + 1)]


def test_device_sampler_refuses_more_than_32_bits():
    with pytest.raises(ValueError):
        TH.sample_indices(1, TL.pack([2]), 2, 33)


@pytest.mark.parametrize("field", ["bn254", "goldilocks"])
def test_batched_stacks_equal_the_streaming_stacks(field):
    # a multi-block dataset: the batched build's stacks are the streaming
    # build's, layer for layer
    cfgs = [SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                       data_src=DataSource("fake", seed=s)) for s in (8, 9)]
    if field == "bn254":
        stacks = TH.batched_slot_layers(cfgs, "cpu")
        want = [TS.streaming_slot_layers(c, chunk_cells=16, device="cpu") for c in cfgs]
    else:
        stacks = TGH.batched_slot_layers_gl("poseidon2", cfgs, "cpu")
        want = [TS.streaming_slot_layers_gl(c, "poseidon2", chunk_cells=16, device="cpu")
                for c in cfgs]
    for got, w in zip(stacks, want):
        assert len(got) == len(w) == 6
        assert all(torch.equal(a, b) for a, b in zip(got, w))


def test_cli_output_is_byte_identical_to_the_jax_cli_oracle(tmp_path):
    flags = ["--field=bn254", "--depth=16", "--maxslots=16", "--cellsize=64",
             "--blocksize=256", "--nslots=3", "--ncells=16", "--nsamples=3",
             "--seed=777", "--entropy=99", "--index=2"]
    ours, theirs = tmp_path / "torch.json", tmp_path / "oracle.json"
    assert cli.main(flags + ["--device=cpu", "--check", f"--output={ours}"]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    subprocess.run(
        [sys.executable, "-m", "codex_storage_proofs_circuits_tpu.utils.cli", *flags,
         "--backend=oracle", f"--output={theirs}"],
        cwd=REPO, env=env, check=True, capture_output=True, timeout=300,
    )
    assert ours.read_bytes() == theirs.read_bytes()


def test_cli_refuses_what_it_cannot_do(tmp_path):
    out = f"--output={tmp_path / 'x.json'}"
    with pytest.raises(SystemExit, match="not available over bn254"):
        cli.main(["--field=bn254", "--hash=monolith", "--device=cpu", out])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--field=bn254", out])  # the default device is cuda
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([out])  # nor on the default field, goldilocks
