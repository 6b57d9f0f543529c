"""Per-stage time of the port's streaming slot build, each stage fenced.

The twin of tools/profile_stages.py.  StreamingStats times the host's
dispatch, and a profiler adds its own host cost; here each stage of one
chunk runs alone, ending in a device sync, so the stages can be set beside
the wall of the whole build:

  prng      ops/fake_prng.gen_rows: a chunk's (2048, B) byte rows (K3)
  encode    no stage on the port's path: K2 and K6 read the byte rows
            themselves (a line says so; nothing is timed)
  sponge    the chunk's cell hashes from its rows: K2 (BN254), K6 (GL)
  reduce    the chunk's tree from its cell hashes: BN254 cut at
            models/streaming.CHUNK_STOP_WIDTH nodes (bn254_chunk_tree, K1),
            GL to the chunk root (K4 for Poseidon2-GL, K5 for Monolith)
  frontier  the slot's joined frontier (the chunks' last layers side by
            side) to the slot root: models/streaming.bn254_tops / gl_tops
  fused     one production chunk, rows to layers (streaming._chunk_layers)
  wall      a warm streaming_slot_root[_gl] of the whole slot

Each stage is timed as the best of 3 windows of 4 calls after one warm-up
call, each window closed by torch.cuda.synchronize() and read on the host
clock.  The last line is wall - chunks x fused - frontier: the host's share
of the build, without a profiler.

    python3 -m tools_torch.profile_stages [--gl [--hash=poseidon2|monolith]]
        [--chunk=18] [--cells=19] [--device=cuda|cpu]

from the root of the checkout (--chunk and --cells are log2 counts; the
slot is fake data of 2048-byte cells in 64 KB blocks, seed 12345).  It runs
on the card unless --device=cpu is given (then give small sizes: the plain
versions take seconds a chunk); without a card --device=cuda fails.  On the
card it prints the card's name and power limit first, and last one JSON
line of the stage times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as L
from codex_storage_proofs_circuits_tpu_torch.ops.fake_prng import fake_seed_bases, gen_rows
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

CELL, BLOCK, SEED = 2048, 65536, 12345


class Stages:
    """The stages of one fake-data slot's streaming build, for BN254 (gl
    False) or one Goldilocks hash; each method is one stage's call."""

    def __init__(self, gl: bool, hash_fun: str, chunk_cells: int, n_cells: int, device):
        self.gl, self.hash_fun, self.chunk = gl, hash_fun, chunk_cells
        self.device = torch.device(device)
        self.cfg = SlotConfig(cell_size=CELL, block_size=BLOCK, n_cells=n_cells, n_samples=1,
                              data_src=DataSource("fake", seed=SEED))
        self.btd = self.cfg.cells_per_block.bit_length() - 1
        self.n_chunks = n_cells // chunk_cells
        self.rows_tree = S.gl_rows_tree(hash_fun) if gl else S.bn254_rows_tree
        self.tops = S.gl_tops(hash_fun) if gl else S.bn254_tops

    def prng(self, c: int = 0) -> torch.Tensor:
        s1, s2 = fake_seed_bases(SEED, c * self.chunk, self.device)
        return gen_rows(s1, s2, CELL, self.chunk)

    def sponge(self, rows: torch.Tensor) -> torch.Tensor:
        if self.gl:
            return GH.sponge_digests_rows(self.hash_fun, rows)
        return H.hash_cells_rows(rows)

    def reduce(self, hashes: torch.Tensor) -> list[torch.Tensor]:
        if self.gl:
            return GH.gl_tree_reduce_layers(hashes, self.hash_fun, (0, self.btd))
        return S.bn254_chunk_tree(hashes, self.btd)

    def frontier(self, front: torch.Tensor, depth: int) -> list[torch.Tensor]:
        """The layers above the joined frontier `front`, which lies at tree
        depth `depth`; none when it is a single node (one chunk)."""
        return self.tops(front, self.btd, depth) if front.shape[-1] > 1 else []

    def fused(self, c: int = 0) -> list[torch.Tensor]:
        return S._chunk_layers(self.cfg, c * self.chunk, self.chunk, self.device,
                               S.StreamingStats(), lambda rows: self.rows_tree(rows, self.btd))

    def wall(self):
        if self.gl:
            return S.streaming_slot_root_gl(self.cfg, self.hash_fun, self.chunk, device=self.device)
        return S.streaming_slot_root(self.cfg, self.chunk, device=self.device)

    def root(self, layer: torch.Tensor):
        """A one-node layer as wall() returns its root."""
        return GH.digests(layer)[0] if self.gl else L.unpack(layer)[0]


def timed(fn, cuda: bool) -> float:
    """Best seconds per fn() call over 3 windows of 4 calls, after one
    warm-up call; each window ends in a device sync."""

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / 4)
    return best


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gl", action="store_true", help="Goldilocks (default: BN254)")
    ap.add_argument("--hash", choices=["poseidon2", "monolith"], default="poseidon2",
                    help="the Goldilocks hash (with --gl)")
    ap.add_argument("--chunk", type=int, default=18, help="log2 of the cells a chunk")
    ap.add_argument("--cells", type=int, default=19, help="log2 of the cells a slot")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.hash != "poseidon2" and not args.gl:
        ap.error("--hash names a Goldilocks hash: give --gl")
    if args.chunk > args.cells:
        ap.error("--chunk is larger than --cells")
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device is available")
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip(), flush=True)

    field = f"gl/{args.hash}" if args.gl else "bn254"
    st = Stages(args.gl, args.hash, 1 << args.chunk, 1 << args.cells, args.device)
    b = st.chunk
    print(f"field={field} chunk=2^{args.chunk} cells=2^{args.cells} device={args.device}",
          flush=True)
    ms: dict = {}
    ms["prng"] = timed(st.prng, cuda) * 1e3
    print(f"prng:     {ms['prng']:10.4f} ms/chunk  ({b * CELL / ms['prng'] / 1e3:.0f} MB/s)",
          flush=True)
    print("encode:   no stage: K2 and K6 read the byte rows themselves", flush=True)
    rows = st.prng()
    ms["sponge"] = timed(lambda: st.sponge(rows), cuda) * 1e3
    print(f"sponge:   {ms['sponge']:10.4f} ms/chunk", flush=True)
    hashes = st.sponge(rows)
    del rows
    ms["reduce"] = timed(lambda: st.reduce(hashes), cuda) * 1e3
    staged = st.reduce(hashes)
    print(f"reduce:   {ms['reduce']:10.4f} ms/chunk  ({len(staged) - 1} levels, to"
          f" {staged[-1].shape[-1]} nodes)", flush=True)
    del hashes
    chunks = [st.fused(c) for c in range(st.n_chunks)]
    if len(staged) != len(chunks[0]) or not all(map(torch.equal, staged, chunks[0])):
        raise AssertionError("the staged chunk's layers differ from the fused chunk's")
    del staged
    depth = len(chunks[0]) - 1
    front = torch.cat([layers[-1] for layers in chunks], dim=-1)
    del chunks
    ms["frontier"] = timed(lambda: st.frontier(front, depth), cuda) * 1e3
    print(f"frontier: {ms['frontier']:10.4f} ms/slot   ({front.shape[-1]} nodes at depth"
          f" {depth})", flush=True)
    if st.root(([front] + st.frontier(front, depth))[-1]) != st.wall():
        raise AssertionError("the chunks and their frontier give another root than the wall's")
    ms["fused"] = timed(st.fused, cuda) * 1e3
    print(f"fused:    {ms['fused']:10.4f} ms/chunk", flush=True)
    ms["wall"] = timed(st.wall, cuda) * 1e3
    print(f"wall:     {ms['wall']:10.4f} ms for 2^{args.cells} cells ({st.n_chunks} chunks,"
          f" {st.cfg.n_cells * CELL / ms['wall'] / 1e3:.0f} MB/s)", flush=True)
    host = ms["wall"] - st.n_chunks * ms["fused"] - ms["frontier"]
    print(f"host:     {host:10.4f} ms = wall - {st.n_chunks} x fused - frontier"
          f" ({100 * host / ms['wall']:.1f} % of the wall)", flush=True)
    print(json.dumps({"field": field, "chunk_cells": b, "n_cells": st.cfg.n_cells,
                      "device": args.device, "ms": ms, "host_ms": host}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
