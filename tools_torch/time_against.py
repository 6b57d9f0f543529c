"""This checkout's hash kernels against another checkout's, on one card.

    python3 -m tools_torch.time_against OTHER_ROOT [--rounds N]

from the root of this checkout.

OTHER_ROOT is the root of another checkout of this repository (for example
the parent commit, unpacked with `git archive` into a directory that
.gitignore lists).  Each round runs one fresh process per checkout, in
turns (other, this, this, other), each importing its own checkout's
package, which builds its kernels at first use, and measuring on the same
seeded inputs the time per call (kernels/timing.py: a kernel's device
time; a path's time end to end, by CUDA events) of:
  - K1, K4 and K5 on one 2^16 -> 2^15 compression;
  - the Goldilocks tree of one main-path chunk (2^18 digests to the root,
    key schedule (0, 5)) as the checkout's gl_tree_reduce_layers builds
    it: one launch a layer, or the subtree kernel where the checkout has
    it (its device time, and by CUDA events end to end);
  - K2 on (34, 2, 16, 2^16) Montgomery blocks and K6 with each core on
    (272, 4, 2^16) felts, the limb-plane entries both checkouts have;
  - the cell-hash step of one 2^16-cell chunk of 2048-byte cells from K3,
    as the checkout's streaming build runs it: the byte-row kernels where
    the checkout has them, else the plain encode (and for BN254 the
    Montgomery form and felt padding), then the limb-plane kernel;
  - M6 at the tools' shapes: W (64, 32) @ A (32, 32768), 64 products, and
    W (128, 128) @ A (128, 32768), 16 products.
Every output must be the same in both checkouts, M6's within
ops/microbench_cuda.DOT_RTOL (a product's sums may run in another order),
the others bit for bit.  Prints the card's name and power limit, then one
JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

from codex_storage_proofs_circuits_tpu_torch.ops.microbench_cuda import DOT_RTOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernels/timing.py of this checkout, loaded by path in both checkouts' runs
TIMING_DIR = os.path.join(ROOT, "codex_storage_proofs_circuits_tpu_torch", "kernels")

MEASURE = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from timing import device_ms, events_ms
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.ops import encode as E
from codex_storage_proofs_circuits_tpu_torch.ops import fake_prng as F
from codex_storage_proofs_circuits_tpu_torch.ops import gl_encode as GE
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as GC
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as P2C

n = 1 << 16
dev = torch.device("cuda")
torch.manual_seed(0)
layer = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=dev)
layer[15] %= 0x3064  # below P: the top limb below P's
digests = torch.randint(0, 1 << 16, (4, 4, n), dtype=torch.int32, device=dev)
blocks = torch.randint(0, 1 << 16, (34, 2, 16, n), dtype=torch.int32, device=dev)
blocks[:, :, 15] %= 0x3064
felts = torch.randint(0, 1 << 16, (272, 4, n), dtype=torch.int32, device=dev)
rows = F.gen_rows(*F.fake_seed_bases(12345, 0, dev), 2048, n)
chunk = torch.randint(0, 1 << 16, (4, 4, 1 << 18), dtype=torch.int32, device=dev)
dot_in = {m: (torch.randint(0, 256, (k, 32768), device=dev).to(torch.bfloat16),
              torch.randint(0, 256, (m, k), device=dev).to(torch.bfloat16))
          for m, k in ((64, 32), (128, 128))}

def bn254_cells():
    if hasattr(H, "hash_cells_rows"):
        return H.hash_cells_rows(rows)
    return H.hash_cells_mont(E.encode_rows(rows))

def gl_cells(h):
    if hasattr(GH, "sponge_digests_rows"):
        return lambda: GH.sponge_digests_rows(h, rows)
    return lambda: GH.sponge_digests(h, GE.encode_rows(rows))

def gl_tree(h):
    return lambda: torch.cat([x.reshape(-1) for x in GH.gl_tree_reduce_layers(chunk, h, (0, 5))])

runs = {  # name: (call, reps, timer)
    "K1 compress": (lambda: P2C.compress_layer(layer[:, 0::2], layer[:, 1::2], 1), 50, device_ms),
    "K4 compress": (lambda: GC.compress(digests[..., 0::2], digests[..., 1::2], 1), 50, device_ms),
    "K5 compress": (lambda: GC.compress(digests[..., 0::2], digests[..., 1::2], 1, "monolith"),
                    50, device_ms),
    "K4 chunk tree": (gl_tree("poseidon2"), 10, device_ms),
    "K5 chunk tree": (gl_tree("monolith"), 10, device_ms),
    "K4 chunk tree, end to end": (gl_tree("poseidon2"), 10, events_ms),
    "K5 chunk tree, end to end": (gl_tree("monolith"), 10, events_ms),
    "K2 limb planes": (lambda: P2C.sponge2_absorb(blocks), 3, device_ms),
    "K6 poseidon2 limb planes": (lambda: GC.sponge_digest_felts(felts, "poseidon2"), 5, device_ms),
    "K6 monolith limb planes": (lambda: GC.sponge_digest_felts(felts, "monolith"), 5, device_ms),
    "BN254 cell hashes of a chunk": (bn254_cells, 3, events_ms),
    "GL poseidon2 cell digests of a chunk": (gl_cells("poseidon2"), 5, events_ms),
    "GL monolith cell digests of a chunk": (gl_cells("monolith"), 5, events_ms),
    "M6 dot64x32": (lambda: MC.dot(*dot_in[64], 64), 20, device_ms),
    "M6 dot128x128": (lambda: MC.dot(*dot_in[128], 16), 20, device_ms),
}
ms, sha, sums = {}, {}, {}
for name, (fn, reps, timer) in runs.items():
    ms[name] = timer(fn, reps)
    if name.startswith("M6"):
        sums[name] = fn().cpu()
    else:
        sha[name] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
torch.save(sums, sys.argv[2])
print(json.dumps({"ms": ms, "sha": sha}))
"""


def _run(root: str, sums_path: str) -> dict:
    """One measurement in a fresh process importing root's package; M6's
    outputs come back as tensors under "sums"."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", MEASURE, TIMING_DIR, sums_path],
                         cwd=root, env=env, capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"measurement in {root} failed:\n{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["sums"] = torch.load(sums_path)
    return res


def _agree(got: dict, want: dict) -> list[str]:
    """Names of M6 outputs further than DOT_RTOL from the first run's."""
    return [name for name, ref in want.items()
            if got[name].shape != ref.shape
            or not bool(((got[name] - ref).abs() <= DOT_RTOL * ref.abs()).all())]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1, help="turns of (other, this, this, other)")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    other = os.path.abspath(args.other_root)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        sums_path = os.path.join(tmp, "sums.pt")
        for _ in range(args.rounds):
            for label, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
                r = _run(root, sums_path)
                if first is None:
                    first = r
                elif r["sha"] != first["sha"]:
                    raise AssertionError(
                        f"outputs differ between the checkouts: {r['sha']} != {first['sha']}")
                elif bad := _agree(r["sums"], first["sums"]):
                    raise AssertionError(f"M6 outputs differ by more than {DOT_RTOL}: {bad}")
                print(json.dumps({"checkout": label, "root": root, "ms": r["ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
