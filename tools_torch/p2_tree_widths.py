"""Device time of a BN254 chunk tree by layer width, on the card.

    python3 -m tools_torch.p2_tree_widths

from the root of the checkout.

One main-path chunk of 2^18 random Montgomery cell hashes is reduced to
its root one layer at a time, one keyed compression launch per layer
(K1's `poseidon2_cuda.compress_layer`, key 1 at depths 0 and 5), and its
layers then taken out of Montgomery form by the plain pass
(`models/hashing.from_mont_layers`), as the chunk tree was built before
the subtree kernel:
  - the device time of each layer's launch by its width (kernels/timing.py:
    calls queued behind a spin kernel), from 2^17 compressions down to 1,
    and the time of the plain pass and of the whole per-layer path by CUDA
    events end to end (the plain pass copies constants from the host);
  - the 18 launches and the plain pass of one chunk in a row under
    torch.profiler: each kernel's device time, the gaps between them on the
    device, their busy time and span, and the host wall through a device
    sync.
Then the subtree entry (`poseidon2_cuda.tree_layers`) on the same chunk,
each call checked against the per-layer layers: the whole chunk tree (18
levels), the chunk cut at 2^14 nodes (4 levels) and a 2^15-node layer to
its root (15 levels, as a 1 GB slot's joined frontier), as the streaming
build runs them, with their launches; and the one-CTA launch by width, 2
to 2^8 nodes.
Prints the card's name and power limit, then one JSON line per part.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.kernels.timing import device_ms, events_ms
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as P2C
from tools_torch.gl_tree_widths import profile_events, summarize

LOG2_CHUNK = 18
KEYS = H.key_bits((0, 5), LOG2_CHUNK)  # the main path's schedule
STOP_LOG = S.CHUNK_STOP_WIDTH.bit_length() - 1


def layer_loop(leaves: torch.Tensor) -> list[torch.Tensor]:
    """The chunk's Montgomery layers by one compression launch per layer."""
    layers = [leaves]
    for d in range(LOG2_CHUNK):
        cur = layers[-1]
        layers.append(P2C.compress_layer(cur[:, 0::2], cur[:, 1::2], (KEYS >> d) & 1))
    return layers


def per_layer(leaves: torch.Tensor) -> list[torch.Tensor]:
    """The per-layer path: the launches, then the plain pass."""
    return H.from_mont_layers(layer_loop(leaves))


def step0(leaves: torch.Tensor) -> dict:
    layers = layer_loop(leaves)
    ms = {}
    for cur in layers[:-1]:
        x, y = cur[:, 0::2], cur[:, 1::2]
        ms[x.shape[1]] = device_ms(lambda: P2C.compress_layer(x, y, 1), 10)
    # the plain pass copies constants from the host, so its calls cannot be
    # queued behind a spin kernel: CUDA events end to end, host gaps included
    plain_ms = events_ms(lambda: H.from_mont_layers(layers), 5)
    per_layer(leaves)  # warm
    ev, _ = profile_events(lambda: per_layer(leaves))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_layer(leaves)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    k1 = [e for e in ev if "p2_perm_kernel" in e[2]]
    return {
        "part": "per-layer", "device_ms_by_width": ms, "from_mont_layers_ms": plain_ms,
        "per_layer_path_ms": events_ms(lambda: per_layer(leaves), 5),
        "profiled": summarize(ev, wall), "k1_profiled": summarize(k1, wall),
    }


def subtree(leaves: torch.Tensor) -> list[dict]:
    want = per_layer(leaves)
    front = LOG2_CHUNK - 15  # the depth of a 2^15-node layer, a 1 GB slot's frontier
    plans = {  # name: (call, the depth of its first layer)
        "chunk tree, 18 levels": (lambda: P2C.tree_layers(leaves, LOG2_CHUNK, KEYS), 0),
        "chunk cut at 2^14 nodes, 4 levels": (lambda: P2C.tree_layers(
            leaves, LOG2_CHUNK - STOP_LOG, KEYS, 1 << STOP_LOG), 0),
        "a 2^15-node frontier to the root, 15 levels": (lambda: P2C.tree_layers(
            want[front], 15, H.key_bits((0, 5), 15, front), mont=False), front),
    }
    rows = []
    for name, (fn, depth) in plans.items():
        before = build.LAUNCHES["p2_tree"]
        got = fn()
        launches = build.LAUNCHES["p2_tree"] - before
        if not all(torch.equal(a, b) for a, b in zip(got, want[depth:], strict=False)):
            raise AssertionError(f"{name}: differs from the per-layer layers")
        rows.append({"part": "subtree", "plan": name, "launches": launches,
                     "ms": device_ms(fn, 10)})
    top = {}
    for k in range(1, 9):
        x = want[LOG2_CHUNK - k]  # 2^k canonical nodes
        top[1 << k] = device_ms(lambda: P2C.tree_layers(x, k, 0, mont=False), 10)
    rows.append({"part": "subtree", "plan": "one CTA by width", "ms_by_width": top})
    return rows


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    torch.manual_seed(0)
    leaves = torch.randint(0, 1 << 16, (16, 1 << LOG2_CHUNK), dtype=torch.int32, device="cuda")
    leaves[15] %= 0x3064  # below P: the top limb below P's
    print(json.dumps(step0(leaves)), flush=True)
    for row in subtree(leaves):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
