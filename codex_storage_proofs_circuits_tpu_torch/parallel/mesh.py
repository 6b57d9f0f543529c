"""Device meshes for the sharded builds.

Port of codex_storage_proofs_circuits_tpu/parallel/mesh.py.  Axes:
  "slots": dataset slots distributed over groups of devices (outer: slots
           are independent until the small dataset tree at the top);
  "cells": the cells of one slot distributed over the devices of a group
           (inner: one frontier node a shard crosses between devices).

torch has no mesh object, so Mesh is a small (slots, cells) grid of
torch.devices.  A device may appear more than once: one card then holds a
2 x 2 or 2 x 4 mesh, as the JAX tests hold eight chips on eight virtual CPU
devices, and a mesh of `cpu` entries runs the plain versions.  In a
multi-process run (parallel/distributed.py) each entry also names the
process that owns it; a process builds only its own entries.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

cells_axis = "cells"
slots_axis = "slots"


@dataclass(frozen=True)
class Mesh:
    """devices[g][c]: the device of cells shard c of slot row g.  ranks[g][c]:
    the process that owns it (None: this process owns every entry);
    rank: this process."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...] | None = None
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {slots_axis: len(self.devices), cells_axis: len(self.devices[0])}

    @property
    def multiprocess(self) -> bool:
        return self.ranks is not None and any(
            r != self.rank for row in self.ranks for r in row
        )

    def is_local(self, g: int, c: int) -> bool:
        return self.ranks is None or self.ranks[g][c] == self.rank

    def local_row(self, g: int) -> bool:
        """Whether this process owns any shard of slot row g."""
        return any(self.is_local(g, c) for c in range(self.shape[cells_axis]))

    def row_leader(self, g: int) -> bool:
        """Whether this process owns the row's first shard: it answers for
        the row's replicated layers in a collective."""
        return self.is_local(g, 0)

    def row_device(self, g: int) -> torch.device:
        """The device that holds the row's replicated layers in this
        process: its first local shard's."""
        return next(d for c, d in enumerate(self.devices[g]) if self.is_local(g, c))


def cuda_devices() -> list[torch.device]:
    """The visible CUDA devices; raises without one (no CPU fallback)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass devices= (e.g. ['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_cells_shards: int | None = None, n_slot_shards: int = 1, devices=None) -> Mesh:
    """(slots, cells) mesh over `devices` (default: the CUDA devices).

    Default: every device on the cells axis.  n_slot_shards > 1 carves the
    device list into that many rows.  Entries may repeat (a mesh of
    several shards on one card).
    """
    devs = [torch.device(d) for d in (cuda_devices() if devices is None else devices)]
    if n_cells_shards is None:
        n_cells_shards = len(devs) // n_slot_shards
    n = n_slot_shards * n_cells_shards
    if n < 1 or n > len(devs):
        raise ValueError(f"a {n_slot_shards} x {n_cells_shards} mesh needs {n} devices,"
                         f" {len(devs)} given")
    return Mesh(tuple(tuple(devs[g * n_cells_shards : (g + 1) * n_cells_shards])
                      for g in range(n_slot_shards)))
