"""Request kind `commit`: each request commits one slot, its bytes hashed
into the slot tree and root (models/streaming.streaming_slot_root, or
streaming_slot_root_gl for Goldilocks).

Traffic parameters:
  data         "device": fake data made on the card from a seed derived
               from --seed and the request counter (the reference's mock
               backend, K3); "file": one slot file of bytes made from
               --seed, written under TMPDIR in set-up and committed again
               by every request through DataSource("file")
  slot_cells   cells a slot
  check_cells  cells of the judged slot that the reference hashes
  warm_up      requests before the window (default 2)
  metric       the end-to-end metric the rate is reported as (default
               commit_gib_per_s)

The judge takes one request, drawn from the seed, of those the window
finished, has the program build that slot's digest layers again, and
judges them (judge.verify_slots).  With file data every request commits
the same bytes: the warm-up request builds their layers (the same chunk
loop, kept on the host during the window), the judge judges those, and
every root of the window is held against the root it gets.
"""

from __future__ import annotations

import os

from port_bench import harness, judge

CHUNK_BYTES = 64 << 20  # the slot file is written in pieces of this size


class Client:
    def __init__(self, spec, seed: int, device, tmpdir: str):
        from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
        from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

        self.S, self.DataSource, self.SlotConfig = S, DataSource, SlotConfig
        self.cfg, self.traffic = spec.config, spec.traffic
        self.seed, self.device, self.tmpdir = seed, device, tmpdir
        self.n = int(self.traffic["slot_cells"])
        self.slot_bytes = self.n * self.cfg["cell_size"]
        self.file = None
        self.stats = S.StreamingStats()
        self.roots: list = []

    def setup(self) -> None:
        """Write the slot file, where the mix commits one."""
        if self.traffic["data"] != "file":
            return
        import torch

        self.file = os.path.join(self.tmpdir, "slot.dat")
        g = torch.Generator(device=self.device)
        g.manual_seed(harness.derive(self.seed, "file", 0, 63))
        with open(self.file, "wb") as f:
            for at in range(0, self.slot_bytes, CHUNK_BYTES):
                piece = torch.randint(0, 256, (min(CHUNK_BYTES, self.slot_bytes - at),),
                                      dtype=torch.uint8, device=self.device, generator=g)
                piece.cpu().numpy().tofile(f)

    def begin(self) -> None:
        """The window starts: the program's stage times count from here."""
        self.stats = self.S.StreamingStats()

    def data_seed(self, i: int) -> int:
        return harness.derive(self.seed, "data", i)

    def slot_cfg(self, i: int):
        if self.file is not None:
            src = self.DataSource("file", filename=self.file)
        else:
            src = self.DataSource("fake", seed=self.data_seed(i))
        return self.SlotConfig(cell_size=self.cfg["cell_size"], block_size=self.cfg["block_size"],
                               n_cells=self.n, n_samples=self.cfg["n_samples"], data_src=src)

    def request(self, i: int):
        if i < 0 and self.file is not None:
            # every request commits the file's bytes: the warm-up builds
            # their layers once, through the same chunk loop, for the judge
            self.file_layers = [lyr.cpu() for lyr in self.layers(i)]
            return None
        if self.cfg["field"] == "bn254":
            return self.S.streaming_slot_root(self.slot_cfg(i), stats=self.stats,
                                              device=self.device)
        return self.S.streaming_slot_root_gl(self.slot_cfg(i), self.cfg["hash"], stats=self.stats,
                                             device=self.device)

    def done(self, i: int, out) -> None:
        self.roots.append(out)

    def end_to_end(self, window_s: float, latencies: list[float]) -> dict:
        rate = len(latencies) * self.slot_bytes / 2**30 / window_s
        return {self.traffic.get("metric", "commit_gib_per_s"): rate}

    def layer_record(self, n_requests: int) -> dict:
        return {"slots": n_requests, "slot_cells": self.n,
                "gib": n_requests * self.slot_bytes / 2**30, "stats": self.stats.as_dict()}

    def layers(self, i: int):
        if self.cfg["field"] == "bn254":
            return self.S.streaming_slot_layers(self.slot_cfg(i), device=self.device)
        return self.S.streaming_slot_layers_gl(self.slot_cfg(i), self.cfg["hash"],
                                               device=self.device)

    def cells(self, i: int):
        if self.file is not None:
            return judge.file_cells(self.cfg["cell_size"], self.file)
        return judge.fake_cells(self.cfg["cell_size"], self.data_seed(i))

    def check(self, rng, layers_of=None) -> dict:
        """The numbers compared, each (value, limit).  layers_of(i) gives
        the digest layers judged (the program's, unless the control puts
        the reference in its place)."""
        k = rng.randrange(len(self.roots))
        if layers_of is None and self.file is not None:
            layers = self.file_layers
        else:
            layers = (layers_of or self.layers)(k)
        btd = (self.cfg["block_size"] // self.cfg["cell_size"]).bit_length() - 1
        case = judge.SlotCase(layers, self.n, self.cells(k))
        counts, roots = judge.verify_slots(judge.field_of(self.cfg), [case], btd,
                                           int(self.traffic["check_cells"]), rng, self.device)
        judged = self.roots if self.file is not None else [self.roots[k]]
        counts["root_mismatches"] = sum(1 for r in judged if r != roots[0])
        return {name: (v, 0) for name, v in counts.items()}
