"""The port's circuit checker and device verifier (models/circuit.py), and
the `--check` of `cspc-torch --field=bn254`, against the JAX package.

The scalar checker's verdicts are held against the JAX package's
check_circuit_semantics on the same clean and tampered proof inputs; the
device verifier (plain versions on the CPU) must give the same verdicts.
The JAX package's own verify_proof_input_device is not called: each call
compiles four lax.scan loops of the Poseidon2 permutation, about a minute
on this CPU, and its tests already hold it to the same verdicts.
"""

import dataclasses

import pytest

from codex_storage_proofs_circuits_tpu.models import circuit as JC
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input as jax_oracle_pi
from codex_storage_proofs_circuits_tpu.utils import cli as jax_cli
from codex_storage_proofs_circuits_tpu_torch.models import circuit as TC
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu_torch.oracle.sampling import generate_proof_input
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu_torch.utils import cli

GLOB = GlobalConfig(max_depth=8, max_log2_n_slots=4, cell_size=64, block_size=256)
DSET = DataSetConfig(n_slots=3, n_cells=16, n_samples=3, data_src=DataSource("fake", seed=12345))
ENTROPY = 1234567


@pytest.fixture(scope="module")
def pi():
    return generate_proof_input(GLOB, DSET, 1, ENTROPY)


def _tampered(pi, what: str):
    if what == "clean":
        return pi
    if what == "cell felt":
        bad = dataclasses.replace(pi, cell_data=[list(c) for c in pi.cell_data])
        bad.cell_data[0][0] ^= 1
    elif what == "path sibling":
        bad = dataclasses.replace(pi, merkle_paths=[list(p) for p in pi.merkle_paths])
        bad.merkle_paths[1][2] ^= 1
    elif what == "slotProof entry":
        bad = dataclasses.replace(pi, slot_proof=list(pi.slot_proof))
        bad.slot_proof[0] ^= 1
    else:  # "dataset root"
        bad = dataclasses.replace(pi, data_set_root=pi.data_set_root ^ 1)
    return bad


CASES = ["clean", "cell felt", "path sibling", "slotProof entry", "dataset root"]


def _verdict(check, *args) -> bool:
    try:
        check(*args)
    except AssertionError:  # CircuitCheckError of either package
        return False
    return True


def test_oracle_input_is_the_jax_oracles(pi):
    jpi = jax_oracle_pi(GLOB, DSET, 1, ENTROPY)
    assert dataclasses.asdict(jpi) == dataclasses.asdict(pi)


@pytest.mark.parametrize("what", CASES)
def test_check_circuit_semantics_verdicts_match_jax(pi, what):
    bad = _tampered(pi, what)
    want = _verdict(JC.check_circuit_semantics, GLOB, DSET, bad)
    assert want == (what == "clean")
    if want:
        TC.check_circuit_semantics(GLOB, DSET, bad)
    else:
        with pytest.raises(TC.CircuitCheckError):
            TC.check_circuit_semantics(GLOB, DSET, bad)


def test_singleton_dataset_check():
    # nSlots = 1: the dataset tree is one bottom-odd compression, and the
    # checker applies the circuit's maskBitsCorrected[0] = 1 fixup
    dset = DataSetConfig(n_slots=1, n_cells=16, n_samples=2, data_src=DataSource("fake", seed=5))
    one = generate_proof_input(GLOB, dset, 0, 7)
    TC.check_circuit_semantics(GLOB, dset, one)
    JC.check_circuit_semantics(GLOB, dset, one)


@pytest.mark.parametrize("what", CASES[:4])
def test_device_verifier_verdicts_match(pi, what):
    bad = _tampered(pi, what)
    want = _verdict(JC.check_circuit_semantics, GLOB, DSET, bad)
    assert TC.verify_proof_input_device(GLOB, bad, device="cpu") is want


def test_cli_check_matches_jax_cli(tmp_path, capsys):
    flags = ["--field=bn254", "--nslots=3", "--ncells=16", "--cellsize=64", "--blocksize=256",
             "--nsamples=3", "--depth=8", "--index=1", "--check"]
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli.main(flags + ["--backend=oracle", f"--output={jax_out}"]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert cli.main(flags + ["--device=cpu", f"--output={port_out}"]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert port_out.read_bytes() == jax_out.read_bytes()
    ok = "circuit semantics check: OK"
    assert ok in jax_lines and ok in port_lines
