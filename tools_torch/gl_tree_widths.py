"""Device time of a Goldilocks chunk tree by layer width, on the card.

    python3 -m tools_torch.gl_tree_widths

from the root of the checkout.

For each hash (K4 Poseidon2-GL, K5 Monolith), one main-path chunk of 2^18
random digests is reduced to its root one layer at a time, one keyed
compression launch per layer (`goldilocks_cuda.compress`), as the chunk
tree was built before the subtree kernel:
  - the device time of each layer's launch by its width (kernels/timing.py:
    calls queued behind a spin kernel), from 2^17 compressions down to 1;
  - the 18 launches of one chunk in a row under torch.profiler: each
    kernel's device time, the gaps between them on the device, their busy
    time and span, and the host wall of the loop through a device sync.
Prints the card's name and power limit, then one JSON line per hash.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from codex_storage_proofs_circuits_tpu_torch.kernels.timing import device_ms
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as GC

LOG2_CHUNK = 18
HASHES = ("poseidon2", "monolith")


def layer_loop(digests: torch.Tensor, hash_fun: str) -> list[torch.Tensor]:
    """The chunk's layers by one compression launch per layer (key 1 at
    depths 0 and 5, the main path's schedule)."""
    layers = [digests]
    for d in range(LOG2_CHUNK):
        cur = layers[-1]
        layers.append(GC.compress(cur[:, :, 0::2], cur[:, :, 1::2], int(d in (0, 5)), hash_fun))
    return layers


def profile_events(fn) -> tuple[list[tuple[int, int, str]], float]:
    """The device kernel events of one fn() as (start us, end us, name),
    in order, and the host wall in ms of fn() through a device sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sorted(ev), wall_ms


def summarize(ev: list[tuple[int, int, str]], wall_ms: float) -> dict:
    busy = sum(b - a for a, b, _ in ev)
    span = ev[-1][1] - ev[0][0] if ev else 0
    return {
        "launches": len(ev),
        "kernel_us": [b - a for a, b, _ in ev],
        "gap_us": [ev[i + 1][0] - ev[i][1] for i in range(len(ev) - 1)],
        "busy_ms": busy / 1e3, "span_ms": span / 1e3, "wall_ms": wall_ms,
    }


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda")
    torch.manual_seed(0)
    digests = torch.randint(0, 1 << 16, (4, 4, 1 << LOG2_CHUNK), dtype=torch.int32, device=dev)
    per_width = {}
    for hash_fun in HASHES:
        layers = layer_loop(digests, hash_fun)
        ms = {}
        for cur in layers[:-1]:
            x, y = cur[:, :, 0::2], cur[:, :, 1::2]
            ms[x.shape[2]] = device_ms(lambda: GC.compress(x, y, 1, hash_fun), 20)
        per_width[hash_fun] = ms
    torch.cuda.synchronize()
    # one profiler session for both hashes (several sessions in one process
    # lose device events), the hashes told apart by the kernel's template
    # argument
    for hash_fun in HASHES:  # warm
        layer_loop(digests, hash_fun)
    ev, _ = profile_events(lambda: [layer_loop(digests, h) for h in HASHES])
    walls = {}
    for hash_fun in HASHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer_loop(digests, hash_fun)
        torch.cuda.synchronize()
        walls[hash_fun] = (time.perf_counter() - t0) * 1e3
    for hash_fun in HASHES:
        tag = "ILi1E" if hash_fun == "monolith" else "ILi0E"
        mine = [e for e in ev if "gl_perm_kernel" in e[2]
                and (tag in e[2] or f"<{HASHES.index(hash_fun)}>" in e[2])]
        print(json.dumps({
            "hash": hash_fun,
            "device_ms_by_width": per_width[hash_fun],
            "layer_loop_profiled": summarize(mine, walls[hash_fun]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
