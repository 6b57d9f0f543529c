"""Sharded dataset build at 1, 2, 4, ... devices: walls, speedup, roots.

The twin of tools/scaling_bench.py.  The full sharded (slots x cells)
dataset build of parallel/tree.sharded_dataset_build (BN254) and
parallel/gl_tree.sharded_gl_dataset_build (Goldilocks, Poseidon2-GL) runs
over meshes of growing device count, the JAX tool's shapes: 1 x n for n < 4
devices, 2 x n/2 from 4 (slots x cells).  Each mesh's wall is the best of 3
builds after one warm-up build (on the CPU: one build, not repeated), ending
in a device sync; speedup and efficiency are against the 1-device mesh, and
every mesh's dataset root must equal the 1-device root.

The JAX tool takes its devices from XLA's virtual devices; here --device
names them: the visible cards (with fewer cards than --n-devices the cards
repeat, one card then holding several shards) or `cpu` entries, which run
the plain versions.  Every row says on how many distinct cards it ran; with
fewer cards than shards the summary's caveat says the rows check the
sharded code and do not measure scaling.

    python3 -m tools_torch.scaling_bench [--cells 4096] [--slots 4]
        [--cell-size 256] [--field bn254|goldilocks|both]
        [--device=cuda|cpu] [--n-devices N] [--out PATH]

from the root of the checkout.  Prints a JSON line per mesh and writes the
summary to --out (default build/scaling_metrics_torch.json; never
scaling_metrics.json).  The cells are fake data (seed 7), encoded on the
host as the JAX tool encodes them, and lie on the first device before the
builds.  Without a card --device=cuda fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.ops import encode as E
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as L
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu_torch.parallel import make_mesh
from codex_storage_proofs_circuits_tpu_torch.parallel.gl_tree import sharded_gl_dataset_build
from codex_storage_proofs_circuits_tpu_torch.parallel.mesh import cuda_devices
from codex_storage_proofs_circuits_tpu_torch.parallel.tree import sharded_dataset_build

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                           "scaling_metrics_torch.json")


def devices_for(device: str, n: int) -> list[torch.device]:
    """n mesh entries: the visible cards in turn (repeating when there are
    fewer than n), or n `cpu` entries."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    cards = cuda_devices()
    return [cards[i % len(cards)] for i in range(n)]


def _sync(devs) -> None:
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _build(field: str, felts, mesh, btd: int, n_slots: int):
    if field == "bn254":
        return sharded_dataset_build(felts, mesh, btd, n_slots)
    return sharded_gl_dataset_build(felts, mesh, "poseidon2", btd, n_slots=n_slots)


def _root(field: str, dataset_layers) -> str:
    top = dataset_layers[-1]
    return str(L.unpack(top)[0]) if field == "bn254" else str(list(GH.digests(top)[0]))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=4096, help="cells per slot")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cell-size", type=int, default=256)
    ap.add_argument("--field", choices=["bn254", "goldilocks", "both"], default="both")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="the largest mesh (default: the visible cards; 8 with --device=cpu)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the summary (JSON)")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device is available")
    n_max = args.n_devices or (torch.cuda.device_count() if cuda else 8)
    devs = devices_for(args.device, n_max)
    repeats = 3 if cuda else 1

    glob = GlobalConfig(max_depth=32, max_log2_n_slots=8, cell_size=args.cell_size,
                        block_size=args.cell_size * 8)
    dset = DataSetConfig(n_slots=args.slots, n_cells=args.cells, n_samples=1,
                         data_src=DataSource("fake", seed=7))
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    btd = cfgs[0].cells_per_block.bit_length() - 1
    cells = [D.load_slot_cells(c) for c in cfgs]

    fields = ["bn254", "goldilocks"] if args.field == "both" else [args.field]
    encode = {"bn254": lambda c: E.encode_cells(torch.from_numpy(c)),
              "goldilocks": GH.encode_cells_gl}
    sizes = [1 << k for k in range(n_max.bit_length()) if 1 << k <= n_max]

    results = {}
    for field in fields:
        felts = torch.stack([encode[field](c) for c in cells]).to(devs[0])
        base = base_root = None
        rows = []
        for nd in sizes:
            n_slot_shards = 2 if nd >= 4 else 1
            n_cell_shards = nd // n_slot_shards
            if dset.n_slots % n_slot_shards or args.cells % n_cell_shards:
                continue
            mesh = make_mesh(n_cells_shards=n_cell_shards, n_slot_shards=n_slot_shards,
                             devices=devs[:nd])
            if cuda:  # warm-up: the kernels' load, the allocator's first allocations
                _build(field, felts, mesh, btd, dset.n_slots)
                _sync(devs[:nd])
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = _build(field, felts, mesh, btd, dset.n_slots)
                _sync(devs[:nd])
                best = min(best, time.perf_counter() - t0)
            root = _root(field, out[2])
            if base is None:
                base, base_root = best, root
            elif root != base_root:
                raise AssertionError(f"{field}: the {n_slot_shards} x {n_cell_shards} mesh's"
                                     f" dataset root {root} differs from 1 device's {base_root}")
            row = {
                "field": field, "devices": nd,
                "mesh": {"slots": n_slot_shards, "cells": n_cell_shards},
                "distinct_cards": len({d for d in devs[:nd] if d.type == "cuda"}),
                "wall_s": best, "speedup": base / best, "efficiency": base / (best * nd),
                "root": root,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
        results[field] = rows

    cards = len({d for d in devs if d.type == "cuda"})
    caveat = None
    if cards < n_max:
        where = f"{cards} cards" if cuda else "the CPU (0 cards)"
        caveat = f"{n_max} shards on {where}: a check of the sharded code, not scaling"
    summary = {
        "backend": args.device,
        "card": torch.cuda.get_device_name(0) if cuda else None,
        "n_devices": n_max, "distinct_cards": cards, "caveat": caveat,
        "config": {"cells": args.cells, "slots": args.slots, "cell_size": args.cell_size},
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    if caveat:
        print(f"# {caveat}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
