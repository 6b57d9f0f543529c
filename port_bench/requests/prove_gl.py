"""Request kind `prove_gl`: each request answers one Goldilocks challenge on a
dataset not seen before, as `cspc-torch --field=goldilocks --output=...`
does after parsing its flags: utils/cli.generate_gl (all slot trees, the
dataset tree, sampling on the device, the sampled cells in one load, their
Merkle paths), then oracle.goldilocks_pipeline.export_proof_input_gl to
one file under TMPDIR, overwritten by each request.  A request's latency
runs from the call to the exported file.

Traffic parameters:
  slots        slots a dataset
  slot_cells   cells a slot
  check_cells  cells of each judged slot that the reference hashes
  warm_up      requests before the window (default 2)

Request i: the dataset's fake-data seed is derived from --seed and i, its
entropy likewise (a fresh 64-bit number, which the program takes as the
CLI takes --entropy: intToDigest), the slot proven is i mod slots;
nSamples, maxDepth, maxSlots and the hash are the configuration's.  The
program's models/gl_proof_input.ProofStatsGL adds up its stages over the window,
which layer_record returns with the export's own clock.  A seeded
reservoir keeps the file of one request, uniform over those the window
finished (os.replace, between requests).  The judge has the program build
that dataset's slot layers again, judges them (judge.verify_slots, with
the sampled cells and their siblings among the leaves it hashes), and
compares the file with the reference (judge_gl.check_proof_json_gl).
"""

from __future__ import annotations

import json
import os
import random
import time

from port_bench import harness, judge, judge_gl
from port_bench.reference import dataset as RD
from port_bench.reference import gl_oracle as RG
from port_bench.trace import EXPORT


class Client:
    def __init__(self, spec, seed: int, device, tmpdir: str):
        import torch

        from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
        from codex_storage_proofs_circuits_tpu_torch.models.gl_proof_input import ProofStatsGL
        from codex_storage_proofs_circuits_tpu_torch.oracle import dataset as D
        from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
            export_proof_input_gl,
        )
        from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource
        from codex_storage_proofs_circuits_tpu_torch.utils import cli

        if spec.config["field"] != "goldilocks":
            raise ValueError("request kind prove_gl: only the goldilocks proof input is judged")
        self.torch, self.S, self.D, self.DataSource = torch, S, D, DataSource
        self.cli, self.export, self.Stats = cli, export_proof_input_gl, ProofStatsGL
        self.cfg, self.traffic = spec.config, spec.traffic
        self.hash = self.cfg["hash"]
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
        self.stats = ProofStatsGL()
        self.export_s: list[float] = []

    def setup(self) -> None:
        pass

    def begin(self) -> None:
        """The window starts: stage and export times count from here."""
        self.stats = self.Stats()
        self.export_s = []

    def data_seed(self, i: int) -> int:
        return harness.derive(self.seed, "data", i)

    def entropy(self, i: int) -> int:
        return harness.derive(self.seed, "entropy", i)

    def dataset(self, i: int):
        return self.D.DataSetConfig(n_slots=self.n_slots, n_cells=self.n,
                                    n_samples=self.cfg["n_samples"],
                                    data_src=self.DataSource("fake", seed=self.data_seed(i)))

    def request(self, i: int):
        pi = self.cli.generate_gl(self.hash, self.glob, self.dataset(i), i % self.n_slots,
                                  self.entropy(i), self.device, stats=self.stats)
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
        return {"proofs": n_requests, "slots": n_requests * self.n_slots, "slot_cells": self.n,
                "proof_gl": self.stats.as_dict(), "export_s": list(self.export_s)}

    def layers(self, i: int, k: int):
        cfg = self.D.slot_cfg_from_dataset_cfg(self.glob, self.dataset(i), k)
        return self.S.streaming_slot_layers_gl(cfg, self.hash, device=self.device)

    def check(self, rng, layers_of=None) -> dict:
        """The numbers compared, each (value, limit).  layers_of(i, k)
        gives slot k's digest layers of request i's dataset (the
        program's, unless a control puts the reference in its place)."""
        i = self.kept_i
        with open(self.kept) as f:
            doc = json.load(f)
        layers_of = layers_of or self.layers
        stacks = [layers_of(i, k) for k in range(self.n_slots)]
        slot_index, entropy = i % self.n_slots, RG.int_to_digest(self.entropy(i))
        btd = (self.cfg["block_size"] // self.cfg["cell_size"]).bit_length() - 1
        fld = judge.field_of(self.cfg)
        mine = stacks[slot_index]
        forced = []
        if len(mine) and mine[-1].shape[-1] == 1:
            forced = judge_gl.proof_leaves_gl(judge_gl.sample_indices_gl(
                self.hash, entropy, fld.value(mine[-1].cpu()), self.n, self.cfg["n_samples"]))
        seeds = [RD.parametric_slot_seed(self.data_seed(i), k) for k in range(self.n_slots)]
        cases = [judge.SlotCase(s, self.n, judge.fake_cells(self.cfg["cell_size"], sd),
                                forced if k == slot_index else [])
                 for k, (s, sd) in enumerate(zip(stacks, seeds))]
        counts, roots = judge.verify_slots(fld, cases, btd, int(self.traffic["check_cells"]),
                                           rng, self.device)
        counts.update(judge_gl.check_proof_json_gl(
            doc, hash_fun=self.hash, entropy=entropy, n_cells=self.n, n_slots=self.n_slots,
            slot_index=slot_index, n_samples=self.cfg["n_samples"],
            max_depth=self.glob.max_depth, max_log2_slots=self.glob.max_log2_n_slots,
            cell_size=self.cfg["cell_size"], slot_seed=seeds[slot_index], roots=roots,
            layers=mine))
        return {name: (v, 0) for name, v in counts.items()}
