"""Helpers of the benchmark's CPU tests: a cell of BENCHMARK.json cut to a
size the CPU runs in seconds (the program and the reference on their
plain torch paths)."""

from __future__ import annotations

import time

from port_bench import harness
from port_bench import spec as SP

SEED = 2**31 + 12345  # larger than 32 signed bits, as a run's seed may be


def tiny_spec(workload: str) -> SP.Spec:
    s = SP.load(workload)
    s.config = dict(s.config, cell_size=64, block_size=256, n_samples=6)
    s.traffic = dict(s.traffic, slot_cells=16, slots=4, check_cells=8)
    return s


def run_tiny(workload: str, trace: bool = False, seed: int = SEED) -> dict:
    return harness.run_cell(tiny_spec(workload), seed, 0.2, trace, "cpu", time.perf_counter())
