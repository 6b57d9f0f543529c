"""Cold build time of the CUDA kernels: one nvcc per source, all started
together (what kernels/build.py does at first use), against the same nvcc
calls run one after another.

    python3 -m codex_storage_proofs_circuits_tpu_torch.kernels.time_build [--rounds N]

Each build goes into a fresh directory under build/torch_kernels/timing/,
which is removed at the end.  The modes alternate (parallel, sequential,
sequential, parallel, ...) so that a drift of the machine touches both.
Prints one JSON object: the host's CPU count and each build's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from . import build


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2, help="builds of each mode")
    args = ap.parse_args(argv)
    root = os.path.join(build.BUILD_ROOT, "timing")
    seconds: dict[str, list[float]] = {"parallel": [], "sequential": []}
    modes = ["parallel", "sequential", "sequential", "parallel"] * args.rounds
    try:
        for i, mode in enumerate(modes[: 2 * args.rounds]):
            out_dir = os.path.join(root, str(i))
            t0 = time.perf_counter()
            build.build_into(out_dir, parallel=mode == "parallel")
            seconds[mode].append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"cpus": os.cpu_count(), "build_s": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
