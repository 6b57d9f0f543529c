"""Request kind `prove`: each request answers one challenge on a dataset
not seen before, as `cspc-torch --field=bn254 --output=...` does after
parsing its flags: utils/cli.generate (all slot trees, the dataset tree,
sampling, the sampled cells and their Merkle paths), then
utils/json_export.export_proof_input to one file under TMPDIR, overwritten
by each request.  A request's latency runs from the call to the exported
file.

Traffic parameters:
  slots        slots a dataset
  slot_cells   cells a slot
  check_cells  cells of each judged slot that the reference hashes
  warm_up      requests before the window (default 2)

Request i: the dataset's fake-data seed is derived from --seed and i, its
entropy likewise (a fresh 248-bit felt), the slot proven is i mod slots;
nSamples, maxDepth and maxSlots are the configuration's.  A seeded
reservoir keeps the file of one request, uniform over those the window
finished (os.replace, between requests).  The judge has the program build
that dataset's slot layers again, judges them (judge.verify_slots, with
the sampled cells and their siblings among the leaves it hashes), and
compares the file with the reference (judge.check_proof_json).
"""

from __future__ import annotations

import json
import os
import random
import time

from port_bench import harness, judge
from port_bench.reference import dataset as RD
from port_bench.trace import EXPORT


class Client:
    def __init__(self, spec, seed: int, device, tmpdir: str):
        import torch

        from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
        from codex_storage_proofs_circuits_tpu_torch.oracle import dataset as D
        from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource
        from codex_storage_proofs_circuits_tpu_torch.utils import cli
        from codex_storage_proofs_circuits_tpu_torch.utils.json_export import export_proof_input

        if spec.config["field"] != "bn254":
            raise ValueError("request kind prove: only the bn254 proof input is judged")
        self.torch, self.S, self.D, self.DataSource = torch, S, D, DataSource
        self.cli, self.export = cli, export_proof_input
        self.cfg, self.traffic = spec.config, spec.traffic
        self.seed, self.device = seed, device
        self.n_slots, self.n = int(self.traffic["slots"]), int(self.traffic["slot_cells"])
        self.glob = D.GlobalConfig(max_depth=self.cfg["max_depth"],
                                   max_log2_n_slots=(self.cfg["max_slots"] - 1).bit_length(),
                                   cell_size=self.cfg["cell_size"],
                                   block_size=self.cfg["block_size"])
        self.path = os.path.join(tmpdir, "proof_input.json")
        self.kept = os.path.join(tmpdir, "kept.json")
        self.keep_rng = random.Random(harness.derive(seed, "keep", 0))
        self.kept_i = None
        self.export_s: list[float] = []

    def setup(self) -> None:
        pass

    def begin(self) -> None:
        """The window starts: export times count from here."""
        self.export_s = []

    def data_seed(self, i: int) -> int:
        return harness.derive(self.seed, "data", i)

    def entropy(self, i: int) -> int:
        return harness.derive(self.seed, "entropy", i, 248)

    def dataset(self, i: int):
        return self.D.DataSetConfig(n_slots=self.n_slots, n_cells=self.n,
                                    n_samples=self.cfg["n_samples"],
                                    data_src=self.DataSource("fake", seed=self.data_seed(i)))

    def request(self, i: int):
        pi = self.cli.generate(self.glob, self.dataset(i), i % self.n_slots, self.entropy(i),
                               self.device)
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(EXPORT):
            self.export(self.path, pi)
        self.export_s.append(time.perf_counter() - t0)
        return None

    def done(self, i: int, out) -> None:
        if self.keep_rng.randrange(i + 1) == 0:
            os.replace(self.path, self.kept)
            self.kept_i = i

    def end_to_end(self, window_s: float, latencies: list[float]) -> dict:
        p = harness.quantiles_ms(latencies)
        return {"proof_p50_ms": p[50], "proof_p90_ms": p[90]}

    def layer_record(self, n_requests: int) -> dict:
        return {"proofs": n_requests, "slots": n_requests * self.n_slots,
                "slot_cells": self.n, "export_s": list(self.export_s)}

    def layers(self, i: int, k: int):
        cfg = self.D.slot_cfg_from_dataset_cfg(self.glob, self.dataset(i), k)
        return self.S.streaming_slot_layers(cfg, device=self.device)

    def check(self, rng, layers_of=None) -> dict:
        """The numbers compared, each (value, limit).  layers_of(i, k)
        gives slot k's digest layers of request i's dataset (the
        program's, unless the control puts the reference in its place)."""
        i = self.kept_i
        with open(self.kept) as f:
            doc = json.load(f)
        layers_of = layers_of or self.layers
        stacks = [layers_of(i, k) for k in range(self.n_slots)]
        slot_index, entropy = i % self.n_slots, self.entropy(i)
        btd = (self.cfg["block_size"] // self.cfg["cell_size"]).bit_length() - 1
        fld = judge.field_of(self.cfg)
        mine = stacks[slot_index]
        forced = []
        if len(mine) and mine[-1].shape[-1] == 1:
            forced = judge.proof_leaves(entropy, fld.value(mine[-1].cpu()), self.n,
                                        self.cfg["n_samples"])
        seeds = [RD.parametric_slot_seed(self.data_seed(i), k) for k in range(self.n_slots)]
        cases = [judge.SlotCase(s, self.n, judge.fake_cells(self.cfg["cell_size"], sd),
                                forced if k == slot_index else [])
                 for k, (s, sd) in enumerate(zip(stacks, seeds))]
        counts, roots = judge.verify_slots(fld, cases, btd, int(self.traffic["check_cells"]),
                                           rng, self.device)
        counts.update(judge.check_proof_json(
            doc, entropy=entropy, n_cells=self.n, n_slots=self.n_slots, slot_index=slot_index,
            n_samples=self.cfg["n_samples"], max_depth=self.glob.max_depth,
            max_log2_slots=self.glob.max_log2_n_slots, cell_size=self.cfg["cell_size"],
            slot_seed=seeds[slot_index], roots=roots, layers=mine))
        return {name: (v, 0) for name, v in counts.items()}
