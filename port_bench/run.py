"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device (and with
--trace 1 the trace's breakdown), and last the numbers the judge compared,
each with its limit; the same numbers are the last lines of standard
error.  Exits 2, printing no result, without as many CUDA devices as the
cell asks for, and 3 if a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "codex_storage_proofs_circuits_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the port's name begins with the JAX package's: whole names compare)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import harness, spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = banned_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
