"""The port's own copies of the JAX package's jax-free modules (fields/,
oracle/, models/data.py, models/witness.py, utils/json_export.py,
utils/circom.py, native/) against their originals: constants table for
table, the oracle's permutations, sponges and Merkle roots on seeded
inputs, the JSON and circom outputs byte for byte, models/data.py and the
C sources of native/ byte for byte, and the C constants headers the port
generates from its fields/ against the JAX package's checked-in ones."""

import dataclasses
import os

import numpy as np
import pytest

import codex_storage_proofs_circuits_tpu.fields.bn254 as JB
import codex_storage_proofs_circuits_tpu.fields.goldilocks as JG
import codex_storage_proofs_circuits_tpu.models.data as JD
import codex_storage_proofs_circuits_tpu.models.witness as JW
import codex_storage_proofs_circuits_tpu.oracle.dataset as JDS
import codex_storage_proofs_circuits_tpu.oracle.goldilocks as JOG
import codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline as JGP
import codex_storage_proofs_circuits_tpu.oracle.merkle as JM
import codex_storage_proofs_circuits_tpu.oracle.poseidon2 as JP
import codex_storage_proofs_circuits_tpu.oracle.sampling as JS
import codex_storage_proofs_circuits_tpu.oracle.slot as JSL
import codex_storage_proofs_circuits_tpu.utils.circom as JC
import codex_storage_proofs_circuits_tpu.utils.json_export as JJ
import codex_storage_proofs_circuits_tpu_torch.fields.bn254 as TB
import codex_storage_proofs_circuits_tpu_torch.fields.goldilocks as TG
import codex_storage_proofs_circuits_tpu_torch.models.data as TD
import codex_storage_proofs_circuits_tpu_torch.models.witness as TW
import codex_storage_proofs_circuits_tpu_torch.native.build as TNB
import codex_storage_proofs_circuits_tpu_torch.oracle.dataset as TDS
import codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks as TOG
import codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline as TGP
import codex_storage_proofs_circuits_tpu_torch.oracle.merkle as TM
import codex_storage_proofs_circuits_tpu_torch.oracle.poseidon2 as TP
import codex_storage_proofs_circuits_tpu_torch.oracle.sampling as TS
import codex_storage_proofs_circuits_tpu_torch.oracle.slot as TSL
import codex_storage_proofs_circuits_tpu_torch.utils.circom as TC
import codex_storage_proofs_circuits_tpu_torch.utils.json_export as TJ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOB = dict(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
DSET = dict(n_slots=3, n_cells=16, n_samples=3)


def _public_constants(mod) -> dict:
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, tuple, list, str))}


@pytest.mark.parametrize("pair", [(JB, TB), (JG, TG), (JOG, TOG), (JP, TP), (JSL, TSL)],
                         ids=["bn254", "goldilocks", "oracle.goldilocks", "oracle.poseidon2",
                              "oracle.slot"])
def test_constants_equal_table_for_table(pair):
    jax_mod, port_mod = pair
    want = _public_constants(jax_mod)
    assert want and _public_constants(port_mod) == want


def test_permutations_sponges_and_merkle_roots_equal():
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = [int.from_bytes(rng.bytes(32), "little") % JB.P for _ in range(3)]
        assert TP.permutation(x) == JP.permutation(x)
        assert TP.sponge2(x) == JP.sponge2(x) and TP.sponge1(x) == JP.sponge1(x)
        leaves = [int.from_bytes(rng.bytes(32), "little") % JB.P for _ in range(5)]
        assert TM.merkle_tree(leaves).root == JM.merkle_tree(leaves).root
        s = [int(v) for v in rng.integers(0, JG.P_GL, 12, dtype=np.uint64)]
        felts = [int(v) for v in rng.integers(0, 1 << 62, 11, dtype=np.uint64)]
        for h in ("poseidon2", "monolith"):
            assert TOG.PERMUTATIONS[h](s) == JOG.PERMUTATIONS[h](s)
            assert TOG.digest_felts(h, felts) == JOG.digest_felts(h, felts)
            digests = [tuple(felts[i : i + 4]) for i in range(0, 8, 4)] * 3
            assert (TM.merkle_tree(digests, TOG.compress_fn(h)).root
                    == JM.merkle_tree(digests, JOG.compress_fn(h)).root)


def test_fake_cells_equal():
    idx = np.arange(5, 17)
    assert np.array_equal(TD.gen_fake_cells(64, 3, idx), JD.gen_fake_cells(64, 3, idx))
    assert np.array_equal(TD.gen_fake_cells(64, 3, [9]), JD.gen_fake_cells(64, 3, [9]))


def test_bn254_exports_and_witness_equal(tmp_path):
    def run(ds, slot, sampling, export, circom, witness, tag):
        glob = ds.GlobalConfig(**GLOB)
        dset = ds.DataSetConfig(**DSET, data_src=slot.DataSource("fake", seed=5))
        pi = sampling.generate_proof_input(glob, dset, 1, 99)
        witness.evaluate_witness(glob, pi, witness.generate_witness(glob, pi))
        export.export_proof_input(str(tmp_path / f"{tag}.json"), pi)
        circom.write_circom_main_component(str(tmp_path / f"{tag}.circom"), glob, dset)
        return ((tmp_path / f"{tag}.json").read_bytes(),
                (tmp_path / f"{tag}.circom").read_bytes(), dataclasses.asdict(pi))

    assert run(TDS, TSL, TS, TJ, TC, TW, "port") == run(JDS, JSL, JS, JJ, JC, JW, "jax")


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_goldilocks_exports_equal(hash_fun, tmp_path):
    def run(ds, slot, pipeline, tag):
        glob = ds.GlobalConfig(**GLOB)
        dset = ds.DataSetConfig(**DSET, data_src=slot.DataSource("fake", seed=5))
        pi = pipeline.generate_proof_input_gl(hash_fun, glob, dset, 2, (7, 0, 0, 0))
        pipeline.check_proof_input_gl(hash_fun, glob, pi)
        out = tmp_path / f"{tag}.json"
        pipeline.export_proof_input_gl(str(out), pi)
        return out.read_bytes()

    assert run(TDS, TSL, TGP, "port") == run(JDS, JSL, JGP, "jax")


@pytest.mark.parametrize("path", ["native/cspc_native.c", "native/cspc_gl.c", "models/data.py"])
def test_copied_sources_equal_byte_for_byte(path):
    def read(pkg):
        with open(os.path.join(REPO, pkg, path), "rb") as f:
            return f.read()

    assert read("codex_storage_proofs_circuits_tpu_torch") == read(
        "codex_storage_proofs_circuits_tpu")


@pytest.mark.parametrize("name", sorted(TNB.HEADERS))
def test_generated_c_headers_equal_the_checked_in_ones(name):
    """Under the default constants, the header the port generates equals the
    JAX package's native/<name> after its first line (which names its
    generator)."""
    with open(os.path.join(REPO, "codex_storage_proofs_circuits_tpu", "native", name)) as f:
        want = f.read()
    got = TNB.HEADERS[name]()
    assert got.startswith("/* generated by codex_storage_proofs_circuits_tpu_torch/native/build.py")
    assert got.split("\n", 1)[1] == want.split("\n", 1)[1]
