"""The port's dryrun_multichip (entry.py), the twin of
__graft_entry__.dryrun_multichip, on a 2 x 2 mesh of CPU shards: it holds
the sharded BN254 and Goldilocks dataset roots and proof inputs to the
port's oracle, the witness evaluator and both semantics checkers; here
what it built is held to the JAX package's oracle as well."""

from dataclasses import asdict

from codex_storage_proofs_circuits_tpu.oracle import dataset as JD
from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import compress_fn
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    calc_slot_tree_gl,
    generate_proof_input_gl,
)
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input
from codex_storage_proofs_circuits_tpu_torch.entry import dryrun_multichip


def _jax(cfg, cls):
    """The same configuration as the JAX package's dataclass cls."""
    fields = asdict(cfg)
    if "data_src" in fields:
        fields["data_src"] = JS.DataSource(**fields["data_src"])
    return cls(**fields)


def test_dryrun_multichip_on_four_cpu_shards(capsys):
    run = dryrun_multichip(4, devices=["cpu"] * 4)
    out = capsys.readouterr().out
    assert "mesh={'slots': 2, 'cells': 2} dataset root OK" in out
    assert "goldilocks proof input OK" in out
    cfgs = [_jax(c, JS.SlotConfig) for c in run["cfgs"]]
    assert len(cfgs) == 3  # an odd slot count over two rows
    assert run["dataset_root"] == merkle_tree([JS.calc_slot_tree(c).root for c in cfgs]).root
    assert run["gl_dataset_root"] == merkle_tree(
        [calc_slot_tree_gl("poseidon2", c).root for c in cfgs], compress_fn("poseidon2")).root
    glob, dset = _jax(run["glob"], JD.GlobalConfig), _jax(run["dset"], JD.DataSetConfig)
    k, entropy = run["slot_index"], run["entropy"]
    assert asdict(run["proof_input"]) == asdict(generate_proof_input(glob, dset, k, entropy))
    assert asdict(run["proof_input_gl"]) == asdict(
        generate_proof_input_gl("poseidon2", glob, dset, k, (entropy, 1, 2, 3)))
