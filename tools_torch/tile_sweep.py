"""The subtree kernels' tiles (the levels one CTA of a wide launch
reduces) and their other constants, by measurement, on the card.

    python3 -m tools_torch.tile_sweep [--field=gl|bn254] [VARIANT ...]

from the root of the checkout.  A VARIANT sets constants of
csrc/goldilocks.cu (--field=gl, the default), as in `kTreeTileLog=9` or
`kTreeTileLog=10,kTrios=false`; by default the tiles 2^6 .. 2^11 (`kTreeTileLog=6` ..
`kTreeTileLog=11`), the rest as in the source.  With --field=bn254 a
VARIANT sets constants of csrc/poseidon2_bn254.cu, as in
`kNarrowTileLog=9` or `kWideTileLog=9,kTreeThreads=128`; by default the
source as it is and the first design's tile (2^9 nodes, 128 threads).

For each variant, a copy of this checkout's package with those constants
set is made under build/tile_sweep/<n>/ (all copies build their kernels at
once, one process each), then measured in a fresh process, one copy after
another: for each hash, the device time (kernels/timing.py) of one
main-path chunk tree, 2^18 digests to the root with key 1 at depths 0 and
5, by the subtree entry, its launches, and a hash of its layers, which must
be the same for every variant; and of the one-CTA launch alone on trees of
2, 2^8 and 2^11 digests.  From each build's ptxas report: the
registers of the wide launch's kernel (2^(k-1) threads a CTA for a tile of
2^k) and the CTAs an SM can hold with them (65536 registers, 2048 threads,
32 CTAs and 228 KB of shared memory an SM; the kernel takes 24 * 2^k
bytes).  For BN254, the device time and launches of the main path's calls
of K1's subtree entry on one 2^18-node chunk of random Montgomery cell
hashes: the chunk cut at 2^14 nodes (4 levels), a 2^15-node layer to its
root (15 levels, a 1 GB slot's joined frontier) and the chunk to its root
(18 levels), with a hash of their layers, which must be the same for
every variant; and the registers of p2_tree_kernel.  Prints the card's name and power limit, then one JSON line per
variant.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "codex_storage_proofs_circuits_tpu_torch"
TIMING_DIR = os.path.join(ROOT, PKG, "kernels")
OUT = os.path.join(ROOT, "build", "tile_sweep")

BUILD = r"""
from codex_storage_proofs_circuits_tpu_torch.kernels import build
build.load()
print(build.build_dir())
"""

MEASURE = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from timing import device_ms
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as GC

dev = torch.device("cuda")
torch.manual_seed(0)
chunk = torch.randint(0, 1 << 16, (4, 4, 1 << 18), dtype=torch.int32, device=dev)
res = {}
for h, counter in (("poseidon2", "gl_perm"), ("monolith", "mono_perm")):
    def fn():
        return GC.tree_layers(chunk, h, 18, 0b100001)
    before = build.LAUNCHES[counter]
    layers = fn()
    launches = build.LAUNCHES[counter] - before
    joined = torch.cat([x.reshape(-1) for x in layers]).cpu().numpy().tobytes()
    res[h] = {"ms": device_ms(fn, 10), "launches": launches,
              "sha": hashlib.sha256(joined).hexdigest()[:16]}
    # the one-CTA launch alone: trees of 2 (one level), 2^8 and 2^11 digests
    res[h]["one_cta_ms"] = {
        w: device_ms(lambda: GC.tree_layers(chunk[:, :, :w], h, w.bit_length() - 1, 1), 10)
        for w in (2, 1 << 8, 1 << 11)}
print(json.dumps(res))
"""


MEASURE_BN254 = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from timing import device_ms
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as P2C

torch.manual_seed(0)
chunk = torch.randint(0, 1 << 16, (16, 1 << 18), dtype=torch.int32, device="cuda")
chunk[15] %= 0x3064  # below P
front = P2C.tree_layers(chunk, 3, 0b1, 1 << 15)[-1]  # 2^15 canonical nodes
calls = {
    "chunk cut at 2^14": lambda: P2C.tree_layers(chunk, 4, 0b1, 1 << 14),
    "2^15 to the root": lambda: P2C.tree_layers(front, 15, 0b100, mont=False),
    "chunk to the root": lambda: P2C.tree_layers(chunk, 18, 0b100001),
}
res, joined = {}, []
for name, fn in calls.items():
    before = build.LAUNCHES["p2_tree"]
    layers = fn()
    res[name] = {"launches": build.LAUNCHES["p2_tree"] - before, "ms": device_ms(fn, 10)}
    joined.append(torch.cat([x.reshape(-1) for x in layers]).cpu().numpy().tobytes())
res["sha"] = hashlib.sha256(b"".join(joined)).hexdigest()[:16]
print(json.dumps(res))
"""

SOURCES = {"gl": "goldilocks.cu", "bn254": "poseidon2_bn254.cu"}
DEFAULTS = {"gl": [f"kTreeTileLog={k}" for k in range(6, 12)],
            "bn254": ["kWideTileLog=11", "kWideTileLog=9,kTreeThreads=128"]}


def _copy(n: int, variant: str, source: str) -> tuple[str, str]:
    """The copy of variant n; returns its root and its changed source."""
    dest = os.path.join(OUT, str(n))
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dest, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dest, PKG, "csrc", source)
    with open(src) as f:
        text = f.read()
    for item in variant.split(","):
        name, value = item.split("=")
        text, count = re.subn(rf"constexpr (int|bool) {name} = [^;]+;",
                              rf"constexpr \g<1> {name} = {value};", text)
        if count != 1:
            raise RuntimeError(f"{name} not found once in csrc/{source}")
    with open(src, "w") as f:
        f.write(text)
    return dest, text


def _registers(build_dir: str, kernel: str, tags: dict[str, str]) -> dict:
    """Registers of the instantiations of `kernel` whose mangled names hold
    each tag, by the tag's label, from ptxas -v."""
    regs, entry = {}, None
    with open(os.path.join(build_dir, "nvcc.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and kernel in entry:
                for label, tag in tags.items():
                    if tag in entry:
                        regs[label] = int(m.group(1))
                entry = None
    return regs


def _ctas_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (per_warp * warps), 2048 // threads, 32, 228 * 1024 // (smem + 1024))


def _run(cmd: str, root: str, *args: str) -> str:
    out = subprocess.run([sys.executable, "-c", cmd, *args], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
                         timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{out.stderr[-4000:]}")
    return out.stdout.strip().splitlines()[-1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--field", choices=sorted(SOURCES), default="gl")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    variants = args.variants or DEFAULTS[args.field]
    copies = {v: _copy(n, v, SOURCES[args.field]) for n, v in enumerate(variants)}
    roots = {v: root for v, (root, _) in copies.items()}
    builds = {k: subprocess.Popen([sys.executable, "-c", BUILD], cwd=r,
                                  env=dict(os.environ, PYTHONPATH=r), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for k, r in roots.items()}
    build_dirs = {}
    for v, p in builds.items():
        out, err = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"build of {v} failed:\n{err[-4000:]}")
        build_dirs[v] = out.strip().splitlines()[-1]
    sha = None
    for v, root in roots.items():
        if args.field == "bn254":
            trees = json.loads(_run(MEASURE_BN254, root, TIMING_DIR))
            if sha is None:
                sha = trees["sha"]
            elif trees["sha"] != sha:
                raise AssertionError(f"{v}: the layers differ from the first variant's")
            regs = _registers(build_dirs[v], "p2_tree_kernel", {"p2_tree_kernel": ""})
            print(json.dumps({"variant": v, "trees": trees, "registers": regs}), flush=True)
            continue
        trees = json.loads(_run(MEASURE, root, TIMING_DIR))
        shas = {h: r.pop("sha") for h, r in trees.items()}
        if sha is None:
            sha = shas
        elif shas != sha:
            raise AssertionError(f"{v}: the layers differ from the first variant's")
        k = int(re.search(r"constexpr int kTreeTileLog = (\d+);", copies[v][1]).group(1))
        threads = 1 << (k - 1)
        regs = _registers(build_dirs[v], "gl_tree_kernel",
                          {"poseidon2": f"ILi0ELi{threads}E", "monolith": f"ILi1ELi{threads}E"})
        print(json.dumps({
            "variant": v, "threads": threads, "trees": trees, "registers": regs,
            "ctas_per_sm": {h: _ctas_per_sm(r, threads, 24 << k) for h, r in regs.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
