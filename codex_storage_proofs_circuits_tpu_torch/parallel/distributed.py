"""Multi-process runs on torch.distributed.

Port of codex_storage_proofs_circuits_tpu/parallel/distributed.py
(jax.distributed and global meshes).  One process per host, or per card:
slots are partitioned over the processes on the mesh's "slots" axis, and
each slot's cells over the process's own devices on the "cells" axis, so
only the slot roots (and, where a row spans processes, the one-node-a-shard
frontiers) cross between processes: O(number of shards) nodes, by
all_reduce, off the hot path.  Every process ends with the same dataset
layers.

The caller names the backend: `nccl` where each process owns its own card,
`gloo` otherwise (CPU processes, or several processes sharing one card);
nothing switches backend by itself.  With gloo the collectives go through
host tensors.

    from codex_storage_proofs_circuits_tpu_torch.parallel import distributed as DD
    DD.initialize("gloo", "tcp://localhost:29500", world_size=2, rank=r)
    mesh = DD.make_global_mesh()                 # slots axis spans processes
    locs, tops, dlayers = sharded_dataset_build_rows(cfgs, mesh, btd)

As a command, one process of such a run (the flags of `cspc-torch` for the
dataset, either field), printing the dataset root and writing the proof
input:

    python -m codex_storage_proofs_circuits_tpu_torch.parallel.distributed \\
        --backend=gloo --init-method=tcp://localhost:29500 --world-size=2 \\
        --rank=0 --field=bn254 --nslots=2 --log2ncells=19 --output=input.json
"""

from __future__ import annotations

import socket
import sys

import torch
import torch.distributed as dist

from .mesh import Mesh, cuda_devices, slots_axis


def initialize(backend: str, init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> None:
    """Join (or start) the process group.

    backend: "nccl" (each process owns one card) or "gloo".  init_method,
    world_size, rank: as torch.distributed takes them (tcp://host:port with
    an explicit size and rank; None reads the environment, as torchrun sets
    it).  Under nccl the processes find out which of them share a host
    (their host names, over a gloo group of the same store) and take the
    host's cards in rank order; more processes on a host than it has cards
    raise.  So one process a host and torchrun's several a host both work.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and n_cards == 0:
        raise ValueError("nccl needs one card a process: this host has no card (use gloo)")
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        # no NCCL communicator exists before the first collective, so the
        # card can still be chosen here
        side = dist.new_group(backend="gloo")
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname(), group=side)
        dist.destroy_process_group(side)
        seat, n_here = host_seat(hosts, dist.get_rank())
        if n_here > n_cards:
            dist.destroy_process_group()
            raise ValueError(f"nccl needs one card a process: {n_here} processes on this"
                             f" host, {n_cards} cards (use gloo to share a card)")
        torch.cuda.set_device(seat)


def host_seat(hosts: list[str], rank: int) -> tuple[int, int]:
    """(this process's place among the processes on its host, in rank
    order; how many there are): its card, and the cards its host needs."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def local_devices() -> list[torch.device]:
    """This process's devices: its current card under nccl, the visible
    cards under gloo; raises without a card (pass devices= for CPU runs)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return cuda_devices()


def make_global_mesh(n_cells_shards: int | None = None, n_slot_shards: int | None = None,
                     devices=None) -> Mesh:
    """(slots, cells) mesh over every process's devices, processes on the
    slots axis.

    devices: this process's devices (default local_devices()); every
    process passes the same number.  Defaults: slots axis = number of
    processes, cells axis = devices a process.  Entries are ordered by
    process, so a C-order reshape keeps each row within one process
    whenever n_cells_shards divides the devices a process.
    """
    local = [torch.device(d) for d in (local_devices() if devices is None else devices)]
    world, me = dist.get_world_size(), dist.get_rank()
    if n_slot_shards is None:
        n_slot_shards = world
    if n_cells_shards is None:
        n_cells_shards = len(local) * world // n_slot_shards
    n = n_slot_shards * n_cells_shards
    entries = [(r, local[i]) for r in range(world) for i in range(len(local))]
    if n < 1 or n > len(entries):
        raise ValueError(f"a {n_slot_shards} x {n_cells_shards} mesh needs {n} devices,"
                         f" {len(entries)} in the run")
    rows = [entries[g * n_cells_shards : (g + 1) * n_cells_shards] for g in range(n_slot_shards)]
    # another process's device is named as that process would name its own
    return Mesh(tuple(tuple(d for _, d in row) for row in rows),
                tuple(tuple(r for r, _ in row) for row in rows), me)


def slot_range_for_process(mesh: Mesh, n_slots_padded: int) -> tuple[int, int]:
    """[start, stop) of the slots this process builds.  Slots are
    block-partitioned over the mesh's slots axis; a process owns the rows
    that hold its devices."""
    n_rows = mesh.shape[slots_axis]
    if n_slots_padded % n_rows:
        raise ValueError(f"{n_slots_padded} slots do not split over {n_rows} mesh rows")
    per = n_slots_padded // n_rows
    mine = [g for g in range(n_rows) if mesh.local_row(g)]
    if not mine:
        raise ValueError(f"process {mesh.rank} owns no mesh row")
    return mine[0] * per, (mine[-1] + 1) * per


class LocalSlots:
    """A process's slots at their global positions, standing for the
    (n_slots_padded, ...) array of a one-process build (torch has no global
    arrays): len() is n_slots_padded, and indexing a slot of another
    process raises."""

    def __init__(self, start: int, slots, n_slots_padded: int):
        self.start, self.slots, self.n_slots_padded = start, slots, n_slots_padded

    def __len__(self) -> int:
        return self.n_slots_padded

    def __getitem__(self, s: int):
        if not self.start <= s < self.start + len(self.slots):
            raise IndexError(f"slot {s} belongs to another process")
        return self.slots[s - self.start]


def make_local_slots(mesh: Mesh, local_slots, n_slots_padded: int) -> LocalSlots:
    """The twin of make_global_cell_array: this process's slots (its
    slot_range_for_process, in order) for the sharded builds."""
    start, stop = slot_range_for_process(mesh, n_slots_padded)
    if len(local_slots) != stop - start:
        raise ValueError(f"process {mesh.rank} holds slots {start}..{stop - 1},"
                         f" {len(local_slots)} given")
    return LocalSlots(start, local_slots, n_slots_padded)


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over all processes, where each entry is non-zero in at
    most one of them: one all_reduce in int64 (exact for integer planes).
    gloo reduces host tensors; nccl tensors on the process's card."""
    if dist.get_backend() == "gloo":
        via = torch.device("cpu")
    else:
        via = torch.device("cuda", torch.cuda.current_device())
    x = t.to(via, torch.int64).contiguous()
    dist.all_reduce(x)
    return x.to(t.dtype).to(t.device)


def main(argv=None) -> int:
    """One process of a multi-process BN254 or Goldilocks run: the dataset
    on the global mesh (byte-row route), the dataset root printed as
    `DATASET_ROOT <value>` and, with --output, the proof input of --index
    written (every process computes the same one)."""
    import argparse

    from ..utils import cli

    p = argparse.ArgumentParser(parents=[cli.build_parser()], add_help=False,
                                conflict_handler="resolve")
    p.add_argument("--backend", required=True, choices=["nccl", "gloo"])
    p.add_argument("--init-method", required=True, help="e.g. tcp://localhost:29500")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--cells-shards", type=int, default=None,
                   help="shards of this process on the cells axis, all on its device"
                        " (default 1)")
    p.add_argument("--slot-shards", type=int, default=None,
                   help="rows of the mesh (default: one a process; 1 makes the cells"
                        " axis span the processes)")
    args = p.parse_args(argv)
    glob, dset = cli.configs_from_args(args)
    initialize(args.backend, args.init_method, args.world_size, args.rank)
    try:
        from .proof_input import sharded_gl_proof_input, sharded_proof_input
        from ..oracle.goldilocks import int_to_digest

        dev = ["cpu"] if args.device == "cpu" else local_devices()[:1]
        devices = dev * (args.cells_shards or 1)
        mesh = make_global_mesh(n_slot_shards=args.slot_shards, devices=devices)
        print(f"rank {args.rank}: backend {args.backend}, mesh {mesh.shape},"
              f" devices {[str(d) for d in devices]}", flush=True)
        if args.field == "bn254":
            pi = sharded_proof_input(glob, dset, args.index, args.entropy, mesh)
            root = str(pi.data_set_root)
        else:
            pi = sharded_gl_proof_input(args.hash, glob, dset, args.index,
                                        int_to_digest(args.entropy), mesh)
            root = " ".join(str(v) for v in pi.data_set_root)
        print(f"DATASET_ROOT {root}", flush=True)
        if args.output:
            if args.field == "bn254":
                from ..utils.json_export import export_proof_input

                export_proof_input(args.output, pi)
            else:
                from ..oracle.goldilocks_pipeline import export_proof_input_gl

                export_proof_input_gl(args.output, pi)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
