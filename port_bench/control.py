"""The control of the judge: the reference put in the program's place,
with one guarantee of the configuration broken, must come out not correct.

    python3 -m port_bench.control --workload <name> --seed <n> [--seed <n> ...]

For each seed: the cell's inputs as a run makes them (request 0, and for
file-backed slots the slot file), the answer worked out by the reference
(judge.plain_layers, the whole slot tree, on the card) with the guarantee
broken, then the judge as a run calls it.  Prints one JSON line a seed
with the numbers compared; exits 1 if any seed came out correct.

  commit: the Merkle keys dropped (key 0 at the cells and at the block
          roots, where the configuration binds the bottom key);
  prove:  half the configuration's nSamples sampled and proven.

The benchmark's runs do not run it.  port_bench/tests/test_pb_control.py
runs the same at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import tempfile
import time

from . import harness, judge
from . import spec as SP
from .reference import dataset as RD
from .reference import merkle as RM
from .reference import sampling as RS
from .reference import slot as RSL


def _commit(client, fld, btd: int, device):
    layers = judge.plain_layers(fld, client.cells(0), client.n, btd, device, keyed=False)
    client.roots = [fld.value(layers[-1])]
    return lambda i: layers


def _prove(client, fld, btd: int, device):
    cfg, n = client.cfg, client.n
    seeds = [RD.parametric_slot_seed(client.data_seed(0), k) for k in range(client.n_slots)]
    stacks = [judge.plain_layers(fld, judge.fake_cells(cfg["cell_size"], s), n, btd, device)
              for s in seeds]
    roots = [fld.value(s[-1]) for s in stacks]
    slot_index, entropy = 0, client.entropy(0)
    tree = RM.merkle_tree(roots)
    idxs = RS.sample_cell_indices(entropy, roots[slot_index], n, cfg["n_samples"] // 2)
    cells = judge.fake_cells(cfg["cell_size"], seeds[slot_index])(idxs)
    depth = len(stacks[slot_index]) - 1
    paths = [[fld.value(stacks[slot_index][d][..., ((i >> d) ^ 1):((i >> d) ^ 1) + 1])
              for d in range(depth)] + [0] * (cfg["max_depth"] - depth) for i in idxs]
    doc = {
        "dataSetRoot": str(tree.root), "entropy": str(entropy), "nCellsPerSlot": n,
        "nSlotsPerDataSet": client.n_slots, "slotIndex": slot_index,
        "slotRoot": str(roots[slot_index]),
        "slotProof": [str(v) for v in RM.extract_proof(tree, slot_index).padded(
            (cfg["max_slots"] - 1).bit_length()).merkle_path],
        "cellData": [[str(v) for v in RSL.cell_data_to_field_elements(c.tobytes())]
                     for c in cells],
        "merklePaths": [[str(v) for v in p] for p in paths],
    }
    with open(client.kept, "w") as f:
        json.dump(doc, f)
    client.kept_i = 0
    return lambda i, k: stacks[k]


CONTROLS = {"commit": _commit, "prove": _prove}


def run_control(cell: SP.Spec, seed: int, device) -> dict:
    """The judge's numbers for the control on one seed."""
    with tempfile.TemporaryDirectory(prefix="port_bench-control-") as tmp:
        kind = cell.traffic["request"]
        client = SP.request_kind(kind).Client(cell, seed, device, tmp)
        client.setup()
        fld = judge.field_of(cell.config)
        btd = (cell.config["block_size"] // cell.config["cell_size"]).bit_length() - 1
        t0 = time.perf_counter()
        layers_of = CONTROLS[kind](client, fld, btd, device)
        t1 = time.perf_counter()
        checks = client.check(random.Random(harness.derive(seed, "judge", 0)), layers_of)
        return {"workload": cell.name, "seed": seed,
                "correct": all(v <= lim for v, lim in checks.values()),
                "control_s": t1 - t0, "judge_s": time.perf_counter() - t1,
                "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = SP.load(args.workload)
    passed = 0
    for seed in args.seed:
        out = run_control(cell, seed, "cuda")
        passed += out["correct"]
        print(json.dumps(out), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
