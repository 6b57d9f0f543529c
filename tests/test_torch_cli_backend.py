"""`cspc-torch --backend` (utils/cli.py): the JAX CLI's choices, so that
workflow/ drives either CLI unchanged.  On small datasets of both fields:
`--backend=oracle` writes the same bytes as `cspc-tpu --backend=oracle`,
`--backend=tpu --device=cpu` (the device path) the same again, and the
flag list of workflow/cli_args.sh parses.  `--backend=native` against
`cspc-tpu --backend=native`: tests/test_torch_native.py."""

import os
import subprocess

import pytest

from codex_storage_proofs_circuits_tpu.utils import cli as jax_cli
from codex_storage_proofs_circuits_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = {
    "bn254": ["--field=bn254", "--nslots=3", "--ncells=16", "--cellsize=64", "--blocksize=256",
              "--nsamples=3", "--depth=8", "--index=1"],
    "monolith": ["--field=goldilocks", "--hash=monolith", "--nslots=3", "--ncells=16",
                 "--cellsize=64", "--blocksize=256", "--nsamples=3", "--depth=8", "--index=2"],
}


@pytest.mark.parametrize("dataset", sorted(FLAGS))
def test_oracle_and_device_backends_write_cspc_tpu_bytes(dataset, tmp_path):
    flags = FLAGS[dataset]
    want = tmp_path / "jax.json"
    assert jax_cli.main(flags + ["--backend=oracle", f"--output={want}"]) == 0
    for backend in (["--backend=oracle"], ["--backend=tpu", "--device=cpu"]):
        got = tmp_path / "port.json"
        assert cli.main(flags + backend + [f"--output={got}", "--check"]) == 0
        assert got.read_bytes() == want.read_bytes(), backend


def test_workflow_flag_list_parses():
    out = subprocess.run(
        ["bash", "-c", 'source workflow/cli_args.sh && printf "%s" "$CLI_ARGS"'],
        cwd=REPO, capture_output=True, text=True, timeout=60, check=True,
        env={k: v for k, v in os.environ.items() if k not in ("BACKEND", "FIELD", "HASH")},
    ).stdout
    args = cli.build_parser().parse_args(out.split())
    assert args.backend == "tpu" and args.device == "cuda" and args.field == "bn254"
    oracle = cli.build_parser().parse_args(out.replace("--backend=tpu", "--backend=oracle").split())
    assert oracle.backend == "oracle"
