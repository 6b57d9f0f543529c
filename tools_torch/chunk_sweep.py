"""Warm 1 GB slot-root walls by streaming chunk size, on the card.

    python3 -m tools_torch.chunk_sweep [--runs N] [--log2-chunks 16 17 18]

from the root of the checkout.

For BN254 and each Goldilocks hash, one 1 GB slot of fake data (2^19 cells
of 2048 bytes, 64 KB blocks, seed 12345) is built once at each chunk size
to warm up, then `runs` times at each size, the sizes taking turns; each
build is timed on the host clock through the device sync that ends it, with
the peak device memory of the build.  The root must not depend on the
chunk size.  Prints the card's name and power limit, then one JSON line per
(path, chunk size).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

SLOT = SlotConfig(cell_size=2048, block_size=65536, n_cells=1 << 19, n_samples=5,
                  data_src=DataSource("fake", seed=12345))
PATHS = {
    "bn254": lambda chunk: S.streaming_slot_root(SLOT, chunk),
    "poseidon2": lambda chunk: S.streaming_slot_root_gl(SLOT, "poseidon2", chunk),
    "monolith": lambda chunk: S.streaming_slot_root_gl(SLOT, "monolith", chunk),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--log2-chunks", type=int, nargs="+", default=[16, 17, 18])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chunk_sweep: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    chunks = [1 << k for k in args.log2_chunks]
    for path, build_root in PATHS.items():
        roots = {build_root(c) for c in chunks}  # warm-up
        walls: dict = {c: [] for c in chunks}
        peaks: dict = {c: 0 for c in chunks}
        for _ in range(args.runs):
            for c in chunks:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                roots.add(build_root(c))
                walls[c].append(time.perf_counter() - t0)
                peaks[c] = max(peaks[c], torch.cuda.max_memory_allocated())
        if len(roots) != 1:
            raise AssertionError(f"{path}: the slot root depends on the chunk size")
        for c in chunks:
            print(json.dumps({"path": path, "chunk_cells": c, "wall_s": walls[c],
                              "peak_gib": peaks[c] / 2**30}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
