"""Two processes joined by torch.distributed (gloo, CPU) build a BN254
dataset on a global mesh (parallel/distributed.py): through the command,
once with the slots axis spanning the processes (each owns one slot), once
with one slot row whose cells axis spans them (the frontier crosses by
all_reduce), and once through the felts route, each process handing its
own slot's encoded cells to sharded_dataset_build as LocalSlots.  Every
rank must print the dataset root of the JAX package's oracle and write
its proof input, byte for byte.  Also the slot ranges of a two-process
mesh, how nccl seats processes on cards, and initialize()'s refusals."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu.utils.json_export import export_proof_input
from codex_storage_proofs_circuits_tpu_torch.parallel import distributed as DD
from codex_storage_proofs_circuits_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--field=bn254", "--device=cpu", "--nslots=2", "--ncells=8", "--cellsize=16",
         "--blocksize=32", "--nsamples=3", "--depth=8", "--maxslots=4", "--index=1",
         "--entropy=4242"]
GLOB = GlobalConfig(max_depth=8, max_log2_n_slots=2, cell_size=16, block_size=32)
DSET = DataSetConfig(n_slots=2, n_cells=8, n_samples=3, data_src=DataSource("fake", seed=12345))

# one process of a felts-route build: its slot's encoded cells as LocalSlots
FELTS_RANK = """
import sys, torch
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE, limbs as TL
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import (
    DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg)
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu_torch.parallel import distributed as DD
glob = GlobalConfig(max_depth=8, max_log2_n_slots=2, cell_size=16, block_size=32)
dset = DataSetConfig(n_slots=2, n_cells=8, n_samples=3, data_src=DataSource("fake", seed=12345))
DD.initialize("gloo", sys.argv[1], world_size=2, rank=int(sys.argv[2]))
mesh = DD.make_global_mesh(devices=["cpu"] * 2)
start, stop = DD.slot_range_for_process(mesh, 2)
felts = [TE.encode_cells(torch.from_numpy(D.load_slot_cells(
    slot_cfg_from_dataset_cfg(glob, dset, s)))) for s in range(start, stop)]
_, _, layers = P.sharded_dataset_build(DD.make_local_slots(mesh, felts, 2), mesh,
                                       glob.block_tree_depth)
print("DATASET_ROOT", TL.unpack(layers[-1])[0], flush=True)
DD.dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(argv) -> list[str]:
    """Start argv(init_method, rank) for ranks 0 and 1, each with a time
    limit; returns their outputs, failing on a rank that fails."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, *argv(init, rank)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=45))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}\n{err[-3000:]}"
    return [out for out, _ in outs]


@pytest.fixture(scope="module")
def oracle_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("oracle") / "pi.json"
    pi = generate_proof_input(GLOB, DSET, 1, 4242)
    export_proof_input(str(path), pi)
    return pi.data_set_root, path.read_bytes()


@pytest.mark.parametrize("layout", [["--cells-shards=2"], ["--cells-shards=2", "--slot-shards=1"]],
                         ids=["slots-across-processes", "cells-across-processes"])
def test_two_gloo_processes_give_the_oracle_proof_input(tmp_path, oracle_json, layout):
    root, want = oracle_json
    outs = _run_two(lambda init, rank: [
        "-m", "codex_storage_proofs_circuits_tpu_torch.parallel.distributed", "--backend=gloo",
        f"--init-method={init}", "--world-size=2", f"--rank={rank}", *FLAGS, *layout,
        f"--output={tmp_path / f'pi_{rank}.json'}"])
    for rank, out in enumerate(outs):
        assert f"DATASET_ROOT {root}" in out.splitlines(), out
        assert (tmp_path / f"pi_{rank}.json").read_bytes() == want


def test_two_gloo_processes_build_local_felts_slots(oracle_json):
    root, _ = oracle_json
    for out in _run_two(lambda init, rank: ["-c", FELTS_RANK, init, str(rank)]):
        assert f"DATASET_ROOT {root}" in out.splitlines(), out


def test_slot_ranges_and_local_slots_of_a_two_process_mesh():
    cpu = torch.device("cpu")
    rows = ((cpu, cpu), (cpu, cpu))
    for rank, want in ((0, (0, 2)), (1, (2, 4))):
        mesh = Mesh(rows, ((0, 0), (1, 1)), rank)
        assert mesh.multiprocess and mesh.local_row(rank) and not mesh.local_row(1 - rank)
        assert DD.slot_range_for_process(mesh, 4) == want
        slots = DD.make_local_slots(mesh, ["a", "b"], 4)
        assert len(slots) == 4 and [slots[s] for s in range(*want)] == ["a", "b"]
        with pytest.raises(IndexError):
            slots[2 - want[0]]
        with pytest.raises(ValueError):
            DD.make_local_slots(mesh, ["a"], 4)
    # one row spread over both processes: each owns half of its shards
    mesh = Mesh(((cpu,) * 4,), ((0, 0, 1, 1),), 1)
    assert DD.slot_range_for_process(mesh, 3) == (0, 3)
    assert [mesh.is_local(0, c) for c in range(4)] == [False, False, True, True]
    assert not mesh.row_leader(0)


def test_nccl_seats_processes_on_their_hosts_cards():
    # one process a host (two hosts of one card each): both take card 0
    assert DD.host_seat(["a", "b"], 1) == (0, 1)
    # two processes on one host (torchrun's layout), ranks interleaved
    assert DD.host_seat(["a", "b", "a", "b"], 2) == (1, 2)
    assert DD.host_seat(["a", "a"], 0) == (0, 2)


def test_initialize_refuses_nccl_without_a_card_a_process_and_unknown_backends():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="one card a process"):
            DD.initialize("nccl", "tcp://127.0.0.1:1", world_size=2, rank=0)
    with pytest.raises(ValueError, match="expected 'nccl' or 'gloo'"):
        DD.initialize("mpi", "tcp://127.0.0.1:1", world_size=1, rank=0)
