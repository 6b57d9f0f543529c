"""The port's host C library (codex_storage_proofs_circuits_tpu_torch/native)
against the port's oracle and the JAX package's native library.

Each test of tests/test_native.py, with its inputs, seeds and shapes, on
the port's bindings: every result equals the oracle's and the JAX
library's exactly (integers and bytes).  Then `cspc-torch --backend=native`
against `cspc-tpu --backend=native`, byte for byte, for bn254 and for
goldilocks with each hash; and a library that does not build (a compiler
that does not exist) makes `--backend=native` exit non-zero, naming the
build error, with no proof input written.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from codex_storage_proofs_circuits_tpu import native as JN
from codex_storage_proofs_circuits_tpu.utils import cli as jax_cli
from codex_storage_proofs_circuits_tpu_torch import native as N
from codex_storage_proofs_circuits_tpu_torch.fields.bn254 import P
from codex_storage_proofs_circuits_tpu_torch.native import build as NB
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu_torch.oracle import merkle as M
from codex_storage_proofs_circuits_tpu_torch.oracle import poseidon2 as O
from codex_storage_proofs_circuits_tpu_torch.oracle import slot as S
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
    calc_slot_tree_gl,
    generate_proof_input_gl,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.sampling import (
    generate_proof_input,
    sample_cell_index,
)
from codex_storage_proofs_circuits_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHES = ["poseidon2", "monolith"]


def both(name: str, *args):
    """The port's native `name`(*args), which must equal the JAX package's."""
    assert N.available(), N.build_error()
    got = getattr(N, name)(*args)
    want = getattr(JN, name)(*args)
    if isinstance(got, np.ndarray):
        assert np.array_equal(got, want), name
    else:
        assert got == want, name
    return got


def test_library_builds_under_build_native():
    assert N.available(), N.build_error()
    out = NB.build_dir()
    assert os.path.dirname(out) == os.path.join(REPO, "build", "native")
    built = {"gl_constants.h", "libcspc_native.so", "poseidon2_constants.h"}
    assert built <= set(os.listdir(out))


def test_permutation_kat():
    # reference/haskell/src/Poseidon2/Example.hs:13-19
    assert both("permutation", (0, 1, 2)) == O.permutation((0, 1, 2))


def test_permutation_random_states():
    rng = np.random.default_rng(1)
    for _ in range(5):
        st = tuple(int(x) % P for x in rng.integers(0, 1 << 63, 3))
        assert both("permutation", st) == O.permutation(st)


def test_sponges_sweep_lengths():
    for n in range(9):
        xs = list(range(1, n + 1))
        assert both("sponge1", xs) == O.sponge1(xs)
        assert both("sponge2", xs) == O.sponge2(xs)


def test_keyed_compression_all_keys():
    for k in range(4):
        assert both("keyed_compression", k, 123, 456) == O.keyed_compression(k, 123, 456)


def test_fake_cells():
    got = both("fake_cells", 96, 777, 3, 4)
    for j in range(4):
        assert got[j].tobytes() == S.gen_fake_cell(96, 777, 3 + j)


def test_hash_cells_byte_padding_sweep():
    # cell sizes straddling 31-byte chunk boundaries sweep the 10* padding
    for cs in (30, 31, 32, 62, 64, 128):
        data = S.gen_fake_cell(cs * 3, 42, 0)
        arr = np.frombuffer(data, np.uint8)
        got = both("hash_cells", arr, cs)
        want = [S.hash_cell_bytes(data[i * cs:(i + 1) * cs]) for i in range(3)]
        assert got == want, cs


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11, 40])
def test_merkle_layers_shapes(n):
    leaves = [(i * 7919 + 13) % P for i in range(n)]
    assert both("merkle_layers", leaves) == M.merkle_tree(leaves).layers


def test_slot_tree_from_bytes():
    cfg = S.SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                       data_src=S.DataSource("fake", seed=9))
    data = np.frombuffer(b"".join(S.load_cell(cfg, i) for i in range(cfg.n_cells)), np.uint8)
    minis, big = both("slot_tree_from_bytes", data, cfg.cell_size, cfg.cells_per_block)
    want = S.calc_slot_tree(cfg)
    assert minis == [t.layers for t in want.mini_trees]
    assert big == want.big_tree.layers


def test_sample_cell_index():
    for c in range(1, 6):
        assert both("sample_cell_index", 111, 222, 64, c) == sample_cell_index(111, 222, 64, c)


def test_generate_proof_input_end_to_end():
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=128, block_size=512)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=4)
    got = N.generate_proof_input_native(glob, dset, 1, 999)
    assert got == generate_proof_input(glob, dset, 1, 999)
    assert vars(got) == vars(JN.generate_proof_input_native(glob, dset, 1, 999))


# -- Goldilocks track --------------------------------------------------------


@pytest.mark.parametrize("hf", HASHES)
def test_gl_permutation_random_states(hf):
    import random

    random.seed(3)
    for _ in range(5):
        s = [random.randrange(OG.P_GL) for _ in range(12)]
        assert both("gl_permutation", hf, s) == OG.PERMUTATIONS[hf](s)


@pytest.mark.parametrize("hf", HASHES)
def test_gl_digest_and_compress(hf):
    for n in (0, 1, 7, 8, 9, 17):
        felts = [(i * 104729 + 7) % OG.P_GL for i in range(n)]
        assert both("gl_digest_felts", hf, felts) == OG.digest_felts(hf, felts)
    x = tuple((i * 7919 + 1) % OG.P_GL for i in range(4))
    y = tuple((i * 6277 + 5) % OG.P_GL for i in range(4))
    for key in range(4):
        assert both("gl_compress", hf, key, x, y) == OG.compress(hf, key, x, y)


@pytest.mark.parametrize("hf", HASHES)
def test_gl_slot_tree_and_sampling(hf):
    cfg = S.SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                       data_src=S.DataSource("fake", seed=9))
    btd = cfg.cells_per_block.bit_length() - 1
    flat = both("gl_slot_tree_layers", hf, cfg.n_cells, cfg.cell_size, cfg.data_src.seed, btd)
    want = calc_slot_tree_gl(hf, cfg)
    assert flat[0] == [d for t in want.mini_trees for d in t.layers[0]]
    assert flat[-1][0] == want.root

    ent = OG.int_to_digest(123456)
    for c in range(1, 5):
        assert both("gl_sample_cell_index", hf, ent, want.root, cfg.n_cells, c) == (
            OG.sample_cell_index_gl(hf, ent, want.root, cfg.n_cells, c)
        )


@pytest.mark.parametrize("hf", HASHES)
def test_gl_generate_proof_input_end_to_end(hf):
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=128, block_size=512)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=3,
                         data_src=S.DataSource("fake", seed=42))
    want = generate_proof_input_gl(hf, glob, dset, 1, OG.int_to_digest(777))
    got = N.generate_proof_input_gl_native(hf, glob, dset, 1, OG.int_to_digest(777))
    assert got == want
    assert vars(got) == vars(
        JN.generate_proof_input_gl_native(hf, glob, dset, 1, OG.int_to_digest(777)))


# -- the command line --------------------------------------------------------

SMALL = ["--nslots=5", "--ncells=64", "--cellsize=256", "--blocksize=4096", "--nsamples=5",
         "--index=3"]
DATASETS = {
    "bn254": ["--field=bn254"],
    "poseidon2": ["--field=goldilocks", "--hash=poseidon2"],
    "monolith": ["--field=goldilocks", "--hash=monolith"],
}


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_cli_native_writes_cspc_tpu_native_bytes(dataset, tmp_path):
    flags = DATASETS[dataset] + SMALL + ["--backend=native"]
    want, got = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli.main(flags + [f"--output={want}"]) == 0
    assert cli.main(flags + [f"--output={got}", "--check"]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_cli_native_exits_when_the_library_does_not_build(tmp_path):
    cc = str(tmp_path / "no-such-cc")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CC"] = cc
    out = tmp_path / "x.json"
    code = ("import os, sys\n"
            "from codex_storage_proofs_circuits_tpu_torch.native import build\n"
            "assert not os.path.exists(build.build_dir())\n"
            "from codex_storage_proofs_circuits_tpu_torch.utils import cli\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    r = subprocess.run([sys.executable, "-c", code, "--field=bn254", *SMALL,
                        "--backend=native", f"--output={out}"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode not in (0, None)
    assert "--backend=native: the host C library did not build" in r.stderr
    assert cc in r.stderr
    assert not out.exists()
