#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (codex_storage_proofs_circuits_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. device: the card's name, power limit and maximum SM clock (nvidia-smi);
  2. build: nvcc builds the kernels of csrc/ (build seconds, ptxas report),
     the static instruction mix of the K2 and K6 byte-row kernels
     (cuobjdump -sass): the share of integer multiplies, and the wide
     multiplies (IMAD.WIDE) a Monolith permutation executes;
  3. each kernel (K1-K6) against its plain torch version on the card,
     bitwise, at the shapes the main paths give it (one chunk of 2^18
     cells of 2048 bytes and one layer of its tree), with the times of both
     and the least time the card could take for the same work (bound_ms;
     a kernel's time is its device time per call, kernels/timing.py).  K1
     is held on its permutation and compression entries (the widest layer)
     and on the subtree entry of the main path over a whole 2^18-leaf
     chunk tree of Montgomery cell hashes, canonical layers out, timed
     beside the 18 per-layer compression launches and the plain
     Montgomery pass it replaces, and on the main path's two calls of it
     (the chunk cut at 2^14 nodes, a 1 GB slot's 2^15-node frontier to its
     root).  K2
     and K6 (both cores) are held on their byte-row entries, which the main
     paths run, and on their limb-plane entries (the JAX parity API), with
     the time of the path the byte-row entries replace: the plain byte
     encode (and for BN254 the Montgomery form and felt padding), then the
     limb-plane kernel.  K4 and K5 are held on the subtree entry of the
     main paths (a whole 2^18-digest chunk tree, two launches), timed
     beside the 18 per-layer compression launches it replaces, and on
     their permutation and compression entries (the widest layer);
  4. BN254: the port CLI on a small dataset (5 slots x 256 cells), which
     must equal the pure-Python oracle exactly;
  5. BN254: the port CLI on two 1 GB fake-data slots (2^19 cells of 2048
     bytes), the streaming path, checked on the host: cell hashes, Merkle
     paths, the dataset proof, the witness evaluator, and the kernels'
     launch counts from that run (K1's subtree kernel at most 8 times, the
     one-layer K1 launch only twice, the sampler's, and no plain Montgomery
     pass but the sampler's one over its nSamples hashes); then
     one warm 1 GB slot-root build, timed, and one under torch.profiler
     (device time by kernel, idle share);
  6. Goldilocks, both hashes: the port CLI on a small dataset (5 slots x
     128 cells), which must equal the oracle's export exactly;
  7. Goldilocks, each hash on its own: the port CLI with --check on two
     1 GB slots, checked on the host (cell digests, Merkle paths, the
     dataset proof, check_proof_input_gl) with the launch counts of that
     run; then one warm 1 GB slot-root build, timed, and one profiled;
  8. the device verifier (models/circuit.verify_proof_input_device) on
     phase 5's proof input, which it must accept, and on three tampered
     copies (a cell felt, a path sibling, a slotProof entry), which it must
     reject; only K1's permutation entry and K2's limb-plane entry may
     launch (the kernels line reports K1's permutation entry from this
     path);
  9. the sharded proof inputs (parallel/) over the same 2 x 1 GB slots on
     a 2 x 2 mesh of shards on this one card, for BN254 and each GL hash:
     each export must equal phase 5's or 7's byte for byte, pass
     check_circuit_semantics / check_proof_input_gl, and launch the byte-row
     kernels of its field and the sampling kernel only; timed beside the
     single-device call in the same phase;
 10. chunk-checkpoint resume of a 1 GB BN254 slot: one chunk, a stop, then
     the resume, whose root must equal phase 5's;
 11. two processes on the card joined by gloo (parallel/distributed.py),
     each building one 1 GB slot of phase 5's dataset: both must print its
     dataset root and write its proof input;
 12. the entry twins (entry.py): entry()'s root against the oracle, and
     dryrun_multichip(8) on a mesh of eight shards on this card;
 13. the host C library (native/) as an independent judge of the card's
     path: a cold build with $CC (the compiler's version, the build
     seconds, the host CPU model and the library's threads); `cspc-torch
     --backend=native` on phase 4's and phase 6's small datasets, whose
     exports must equal those phases' byte for byte; and one whole 1 GB
     slot of phase 5's dataset and of phase 7's (each hash), whose native
     root must equal the device's slot root and whose 2^14 block roots must
     equal the device's, block for block.  No kernel may launch while the
     native path runs; the native walls are printed beside the device's
     build of the same slot;
 14. the port's measurement tools: bench_torch.py in a process of its own
     at full size (it must exit 0 and print one JSON line; its three 1 GB
     roots must equal this script's own streaming_slot_root[_gl] of the
     same slot; no compress chain of it may beat the device time of the
     same call, kernels/timing.device_ms, by more than 5 %), then
     tools_torch/profile_stages.py for BN254 and each GL hash, and
     tools_torch/scaling_bench.py on four shards of this card for both
     fields (the roots of its 1, 2 and 4-shard meshes must agree);
 15. the microbenchmark kernels M1-M6 (csrc/microbench.cu), the twins of
     the TPU's tools/microbench.py and tools/microbench2.py: both port
     tools (tools_torch/microbench*.py) run every variant at their full
     shapes (their launch counts are that path's), then each variant is
     held against its plain version on the card (M1-M5 bitwise, M6 within
     a relative 2.5e-4); each kernel's rate of the instructions that bound
     it, an SM a clock at the maximum SM clock, is set beside its peak
     (IMAD and integer logic 64, both integer pipes 128, conversions 16,
     bf16 tensor-core MACs 2048; M3's bound is that of the pipes its SASS
     loads most, tools_torch/microbench.sass_bound), and a kernel above
     105 % of its peak fails the phase (the compiler removed work), as
     does a build whose SASS lacks the IMAD of M1, M3 and M4, the I2F and
     F2I of M5 or the HGMMA (wgmma) of M6, or still holds an HMMA
     (mma.sync) in M6 (phase 2 counts them).  M6's rate in steady state,
     from the time of twice the tools' products less that of their count,
     is logged beside the same peak.  The u32 multiply rate of M1 and M4
     (ilp8) stands beside IMAD_PER_CLOCK, which bound() assumes.

Each main path (phase 5, phase 7 once per hash, and phase 15's tools) sets the launch counts
to 0 just before its CLI run and reads them just after: every kernel of
that path must have launched, and no other kernel, nor the limb-plane
entries of K2 and K6 (counted apart from their byte-row entries); a GL
path launches K4 or K5 (the subtree kernel) at most 12 times.  Phases 8
and 9 reset and read the counts around their own runs, against the
kernels each names.

Prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Phase 13 sets the launch counts to 0 before its native runs and reads them
after: they must all still be 0.  Any failed check raises: the exit code
is then non-zero and there is no result line.  Without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from codex_storage_proofs_circuits_tpu_torch.fields import bn254
from codex_storage_proofs_circuits_tpu_torch.fields import goldilocks as GLF
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks as GO
from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
    check_proof_input_gl,
    export_proof_input_gl,
    generate_proof_input_gl as oracle_proof_input_gl,
)
from codex_storage_proofs_circuits_tpu_torch.models.data import gen_fake_cells
from codex_storage_proofs_circuits_tpu_torch.models.witness import evaluate_witness, generate_witness
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import slot_cfg_from_dataset_cfg
from codex_storage_proofs_circuits_tpu_torch.oracle.merkle import MerkleProof, reconstruct_root
from codex_storage_proofs_circuits_tpu_torch.oracle.sampling import generate_proof_input as oracle_proof_input
from codex_storage_proofs_circuits_tpu_torch.oracle.sampling import sample_cell_indices
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import (
    cell_data_to_field_elements,
    check_cell_proof,
    gen_fake_cell,
    hash_cell_bytes,
)
from codex_storage_proofs_circuits_tpu_torch.utils.json_export import load_proof_input
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.kernels.timing import device_ms, events_ms
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.ops import encode as E
from codex_storage_proofs_circuits_tpu_torch.ops import fake_prng as F
from codex_storage_proofs_circuits_tpu_torch.ops import gl_encode as GE
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as GC
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as GP
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as L
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MBC
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_plain as MBP
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as P2C
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as P2
from codex_storage_proofs_circuits_tpu_torch.utils import cli
from codex_storage_proofs_circuits_tpu_torch.utils.json_export import export_proof_input
from codex_storage_proofs_circuits_tpu_torch import entry as EN
from codex_storage_proofs_circuits_tpu_torch import parallel as PAR
from codex_storage_proofs_circuits_tpu_torch.models.circuit import (
    check_circuit_semantics,
    verify_proof_input_device,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig, calc_slot_tree

import bench_torch as BT
from tools_torch import microbench as MB
from tools_torch import microbench2 as MB2
from tools_torch import profile_stages as PS
from tools_torch import scaling_bench as SB

CHUNK = S.DEFAULT_CHUNK_CELLS  # cells per streaming chunk on the main path
CELL = 2048
SEED = 12345
HASHES = ("poseidon2", "monolith")
SMALL_BN254 = ["--field=bn254", "--nslots=5", "--ncells=256"]  # phases 4 and 13
SMALL_GL = ["--nslots=5", "--ncells=128"]  # phases 6 and 13, with --hash
_SRC = "codex_storage_proofs_circuits_tpu_torch/csrc/"
_TPU = "codex_storage_proofs_circuits_tpu/ops/"
# launch counter -> (name, source, TPU kernel replaced)
KERNELS = {
    "p2_tree": ("poseidon2_bn254_tree", _SRC + "poseidon2_bn254.cu", _TPU + "poseidon2_pallas.py:297"),
    "perm": ("poseidon2_bn254_perm", _SRC + "poseidon2_bn254.cu", _TPU + "poseidon2_pallas.py:297"),
    "sponge2": ("poseidon2_bn254_sponge2", _SRC + "poseidon2_bn254.cu", _TPU + "poseidon2_pallas.py:324"),
    "prng": ("fake_prng_rows", _SRC + "fake_prng.cu", _TPU + "fake_prng.py:217"),
    "gl_perm": ("poseidon2_gl_tree", _SRC + "goldilocks.cu", _TPU + "goldilocks_pallas.py:193"),
    "mono_perm": ("monolith_tree", _SRC + "goldilocks.cu", _TPU + "goldilocks_pallas.py:164"),
    "gl_sponge8": ("poseidon2_gl_sponge8", _SRC + "goldilocks.cu", _TPU + "goldilocks_pallas.py:206"),
    "mono_sponge8": ("monolith_sponge8", _SRC + "goldilocks.cu", _TPU + "goldilocks_pallas.py:206"),
    "mb_mul": ("microbench_mul", _SRC + "microbench.cu", "tools/microbench.py:28"),
    "mb_add": ("microbench_add", _SRC + "microbench.cu", "tools/microbench.py:37"),
    "mb_mix": ("microbench_mix", _SRC + "microbench.cu", "tools/microbench.py:46"),
    "mb_ilp": ("microbench_ilp", _SRC + "microbench.cu", "tools/microbench2.py:31"),
    "mb_conv": ("microbench_conv", _SRC + "microbench.cu", "tools/microbench2.py:46"),
    "mb_dot": ("microbench_dot", _SRC + "microbench.cu", "tools/microbench2.py:56"),
}
PATH_COUNTERS = {  # the kernels each path must launch, and no other
    "bn254": ("p2_tree", "sponge2", "prng"),
    "poseidon2": ("prng", "gl_perm", "gl_sponge8"),
    "monolith": ("prng", "mono_perm", "mono_sponge8"),
    "verifier": ("perm", "sponge2_planes"),
    "microbench": ("mb_mul", "mb_add", "mb_mix", "mb_ilp", "mb_conv", "mb_dot"),
}
# subtree launches of a path: K4 / K5 of a GL path, 2 slots x (2 chunks x 2
# + 1 top); K1 of the BN254 path, 2 slots x (2 chunks cut at 2^14 nodes + 2
# for the joined frontier)
MAX_TREE_LAUNCHES = {"gl_perm": 12, "mono_perm": 12, "p2_tree": 8}
CHUNK_KEYS = 0b100001  # key 1 at depths 0 and 5 of a chunk: the main path's schedule

# The card's peak rates for the bound (NVIDIA H100 SXM data sheet): device
# memory 3.35 TB/s; 32-bit integer multiply-adds 64 per clock on each of 132
# SMs, at the maximum SM clock nvidia-smi reports (set in main()).
MEM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_CLOCK = 132, 64
SM_CLOCK_HZ = 0.0

# 32-bit integer multiply instructions, counted by hand from the sources as
# the kernels issue them: each mul.lo / mul.hi / mad.lo / mad.hi counts 1
# (a 32 x 32 -> 64 product is 2).  Multiplies by the small constants of the
# linear layers (Monolith's Concrete) are left out, so each count is a
# lower bound; the Poseidon2 linear layers have none.
#   BN254 (csrc/poseidon2_bn254.cu): a Montgomery product is 8 steps of
#     8 + 8 (a * b_i), 1 (the quotient) and 8 + 8 (m * P): 264; a squaring
#     28 + 28 cross products, 8 + 8 squares and 8 reduction steps of
#     1 + 8 + 8: 208; x^5 two squarings and a product: 680; a permutation 80
#     S-boxes (3 in each of 8 external rounds, 1 in each of 56 internal).
#     K2 from byte rows adds one product (by R^2 mod P) per felt.
#   K3, per byte: two 64 x 64 -> 64 products (4 each), one 64 x 64 -> high 64
#     by the modulus' reciprocal (8) and the quotient times the modulus (4).
#   Goldilocks (csrc/goldilocks.cu), per permutation: a modular product is 4
#     wide products (8).  Poseidon2-GL: 8 x 12 x^7 (4 products each) in the
#     external rounds, 22 x (4 + 12) in the internal ones = 736 products.
#     Monolith: 6 rounds x 11 squares in Bricks = 66 products.
BN254_MUL, BN254_SQR = 264, 208
BN254_PERM = 80 * (2 * BN254_SQR + BN254_MUL)
PRNG_BYTE = 20
GL_PERM = {"poseidon2": 736 * 8, "monolith": 66 * 8}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: int, muls: int) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the multiply instructions over the integer multiply rate."""
    mem_ms = n_bytes / MEM_BYTES_PER_S * 1e3
    op_ms = muls / (SMS * IMAD_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    return {"bound_ms": max(mem_ms, op_ms), "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name: str, kernel, plain, reps: int, results: dict, work=None, timed=None) -> None:
    """Kernel against plain version on the same inputs: bitwise equal, both
    timed (the kernel by its device time per call, kernels/timing.py: of
    timed(), the kernel's call itself where kernel() also joins its
    outputs into one tensor).  work = (bytes, multiply instructions) of one
    kernel call, for its bound; the last call compared under a name is the
    one reported."""
    got = kernel()
    torch.cuda.synchronize()
    want = None

    def run_plain():
        nonlocal want
        want = plain()

    plain_ms = events_ms(run_plain, 1, warmup=False)  # the plain versions take seconds
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    ms = device_ms(timed or kernel, reps)
    log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.1f} ms")
    if got.shape != want.shape or err != 0:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    r = results.setdefault(name, {"max_abs_err": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r.update(ms=ms, plain_ms=plain_ms, library_ms=None)
    if work is not None:
        r.update(bound(*work))
        log(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            f" ({100 * r['bound_ms'] / ms:.1f} % of it)")


def random_canonical(rng, shape) -> torch.Tensor:
    """Random limb planes of values < P (top limb below P's)."""
    arr = rng.integers(0, 1 << 16, size=shape, dtype=np.int32)
    arr[..., 15, :] = rng.integers(0, bn254.P >> 240, size=arr[..., 15, :].shape)
    return torch.from_numpy(arr).cuda()


def phase_kernels(results: dict) -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    # K1: the permutation KAT, random states, and the compress of one layer
    # of a main-path chunk (2^16 -> 2^15 nodes)
    kat = torch.stack([L.pack([bn254.to_mont(v)], dev) for v in bn254.PERMUTATION_KAT_INPUT])
    out = P2C.permutation(kat)
    got = tuple(bn254.from_mont(L.unpack(out[k])[0]) for k in range(3))
    if got != bn254.PERMUTATION_KAT_OUTPUT:
        raise AssertionError("K1 permutation KAT failed")
    log("  perm: KAT ok")
    states = random_canonical(rng, (3, 16, 4096))
    compare("perm", lambda: P2C.permutation(states), lambda: P2.permutation(states), 20, results)
    layer = random_canonical(rng, (16, CHUNK))
    compare(
        "perm",
        lambda: P2C.compress_layer(layer[:, 0::2], layer[:, 1::2], 1),
        lambda: P2.compress(layer[:, 0::2], layer[:, 1::2], P2.KEY_MONT[1]),
        20,
        results,
        (nbytes(layer) + nbytes(layer[:, 0::2]), CHUNK // 2 * BN254_PERM),
    )

    # K1's subtree entry: a main-path chunk's whole tree, 2^18 Montgomery
    # cell hashes to the root with key 1 at depths 0 and 5, canonical layers
    # out, beside the 18 per-layer launches and the plain Montgomery pass it
    # replaces; then the main path's two calls: the chunk cut at 2^14 nodes
    # (4 levels) and a 1 GB slot's joined 2^15-node frontier (canonical) to
    # its root (15 levels, from depth 4), each also held against its plain
    # version
    depth, keys = CHUNK.bit_length() - 1, CHUNK_KEYS

    def per_layer():
        layers = [layer]
        for d in range(depth):
            cur = layers[-1]
            layers.append(P2C.compress_layer(cur[:, 0::2], cur[:, 1::2], (keys >> d) & 1))
        return H.from_mont_layers(layers)

    def joined(layers):
        return torch.cat([lyr.reshape(-1) for lyr in layers])

    def tree():
        return P2C.tree_layers(layer, depth, keys)

    compare("p2_tree", lambda: joined(tree()), lambda: joined(P2.tree_layers(layer, depth, keys)),
            10, results,
            (nbytes(layer) + 16 * 4 * (2 * CHUNK - 1),
             (CHUNK - 1) * BN254_PERM + (2 * CHUNK - 1) * BN254_MUL),
            timed=tree)
    if not torch.equal(joined(tree()), joined(per_layer())):
        raise AssertionError("p2_tree: the subtree entry differs from the per-layer path")
    per_layer_ms = events_ms(per_layer, 3)  # the plain pass copies from the host
    results["p2_tree"]["per_layer_ms"] = per_layer_ms
    log(f"    the {depth} per-layer launches and the plain pass it replaces: {per_layer_ms:.4f} ms"
        " (CUDA events end to end)")
    stop = S.CHUNK_STOP_WIDTH
    cut = P2C.tree_layers(layer, depth - stop.bit_length() + 1, keys, stop)
    front = torch.cat([cut[-1], random_canonical(rng, (16, stop))], dim=1)
    plans = {
        "chunk_cut": lambda: P2C.tree_layers(layer, len(cut) - 1, keys, stop),
        "frontier": lambda: P2C.tree_layers(front, 15, H.key_bits((0, 5), 15, len(cut) - 1),
                                            mont=False),
    }
    plain_plans = {
        "chunk_cut": lambda: P2.tree_layers(layer, len(cut) - 1, keys),
        "frontier": lambda: P2.tree_layers(front, 15, H.key_bits((0, 5), 15, len(cut) - 1),
                                           mont=False),
    }
    r = results["p2_tree"]
    for name, fn in plans.items():
        before = build.LAUNCHES["p2_tree"]
        fn()
        n = build.LAUNCHES["p2_tree"] - before
        compare(f"p2_tree:{name}", lambda fn=fn: joined(fn()),
                lambda plain=plain_plans[name]: joined(plain()), 10, results, timed=fn)
        r["max_abs_err"] = max(r["max_abs_err"], results[f"p2_tree:{name}"]["max_abs_err"])
        r[f"{name}_ms"] = results[f"p2_tree:{name}"]["ms"]
        log(f"    main-path call {name}: {n} launches")

    # K3: one main-path chunk of fake cells, and a few cells against the
    # host generator
    s1, s2 = F.fake_seed_bases(SEED, 0, dev)
    compare(
        "prng",
        lambda: F.gen_rows(s1, s2, CELL, CHUNK),
        lambda: F.gen_rows_plain(*F.seed_planes(s1, s2, CHUNK), CELL),
        20,
        results,
        (nbytes(s1, s2) + CELL * CHUNK, CELL * CHUNK * PRNG_BYTE),
    )
    rows = F.gen_rows(s1, s2, CELL, CHUNK)
    host = gen_fake_cells(CELL, SEED, np.arange(8))
    if not np.array_equal(rows[:, :8].T.cpu().numpy(), host):
        raise AssertionError("K3 disagrees with models.data.gen_fake_cells")
    log("  prng: first 8 cells equal models.data.gen_fake_cells")

    # K2 over that chunk: the limb-plane entry on the padded Montgomery
    # blocks of its cells (34 blocks of 2 felts), the path it replaces
    # (plain encode, Montgomery form and felt padding, then the limb-plane
    # kernel), and last the byte-row entry of the main path on the rows
    # themselves (67 felts into Montgomery form, 34 permutations)
    def unfused_sponge2():
        return P2C.sponge2_absorb(P2.pad_felts_rate2(P2.to_mont_stack(E.encode_rows(rows))))

    blocks = P2.pad_felts_rate2(P2.to_mont_stack(E.encode_rows(rows)))
    nb, nf = blocks.shape[0], E.n_chunks(CELL)
    compare("sponge2:planes", lambda: P2C.sponge2_absorb(blocks),
            lambda: P2.sponge2_absorb(blocks), 3, results,
            (nbytes(blocks) + 16 * 4 * CHUNK, CHUNK * nb * BN254_PERM))
    unfused_ms = events_ms(unfused_sponge2, 3)
    log(f"    the path the byte-row entry replaces: {unfused_ms:.4f} ms")
    results["sponge2:planes"]["unfused_ms"] = unfused_ms
    compare("sponge2", lambda: P2C.sponge2_rows(rows), lambda: P2.sponge2_rows(rows), 3, results,
            (nbytes(rows) + 16 * 4 * CHUNK, CHUNK * (nb * BN254_PERM + nf * BN254_MUL)))

    # K4 / K5: the KAT state [0..11] against the oracle, random states, the
    # key-1 compression of a main-path chunk's widest layer (2^18 -> 2^17
    # digests) and, as the main path runs them, all 18 layers of that
    # chunk's tree (key schedule (0, 5)) by the subtree entry, beside the 18
    # one-layer launches it replaces; K6 with each core over the chunk's
    # encoded cells (272 felts a cell), the path its byte-row entry replaces
    # (plain encode, then the felt kernel), and last the byte-row entry over
    # the rows (34 chunks, then the padding block: 35 permutations)
    felts = GE.encode_rows(rows)
    nch = GE.n_chunks(CELL)
    digests = torch.from_numpy(rng.integers(0, 1 << 16, (4, 4, CHUNK), dtype=np.int32)).cuda()
    kat = torch.stack([GP.pack([v], dev) for v in range(12)])
    depth = CHUNK.bit_length() - 1
    for hash_fun in HASHES:
        perm, sponge = ("gl_perm", "gl_sponge8") if hash_fun == "poseidon2" else (
            "mono_perm", "mono_sponge8")
        out = GC.permutation(kat, hash_fun)
        if [GP.unpack(out[i])[0] for i in range(12)] != GO.PERMUTATIONS[hash_fun](list(range(12))):
            raise AssertionError(f"{perm}: permutation of [0..11] differs from the oracle")
        log(f"  {perm}: KAT ok")
        states = torch.from_numpy(rng.integers(0, 1 << 16, (12, 4, 4096), dtype=np.int32)).cuda()
        compare(f"{perm}:layer", lambda: GC.permutation(states, hash_fun),
                lambda: GP.permutation(states, hash_fun), 20, results)
        x, y = digests[:, :, 0::2], digests[:, :, 1::2]
        compare(f"{perm}:layer", lambda: GC.compress(x, y, 1, hash_fun),
                lambda: GP.compress_batch(hash_fun, 1, x, y), 20, results,
                (nbytes(digests) + nbytes(x), CHUNK // 2 * GL_PERM[hash_fun]))

        def tree():
            return GC.tree_layers(digests, hash_fun, depth, CHUNK_KEYS)

        def per_layer():
            layers = [digests]
            for d in range(depth):
                cur = layers[-1]
                layers.append(GC.compress(cur[:, :, 0::2], cur[:, :, 1::2],
                                          (CHUNK_KEYS >> d) & 1, hash_fun))
            return layers

        def joined(layers):
            return torch.cat([lyr.reshape(-1) for lyr in layers])

        compare(perm, lambda: joined(tree()),
                lambda: joined(GP.tree_layers(hash_fun, digests, depth, CHUNK_KEYS)), 10, results,
                (nbytes(digests) + 16 * 4 * (CHUNK - 1), (CHUNK - 1) * GL_PERM[hash_fun]),
                timed=tree)
        if not torch.equal(joined(tree()), joined(per_layer()[1:])):
            raise AssertionError(f"{perm}: the subtree entry differs from the per-layer launches")
        per_layer_ms = device_ms(per_layer, 10)
        results[perm]["per_layer_ms"] = per_layer_ms
        log(f"    the {depth} per-layer launches it replaces: {per_layer_ms:.4f} ms")
        compare(f"{sponge}:planes", lambda: GC.sponge_digest_felts(felts, hash_fun),
                lambda: GP.sponge_digest_felts(hash_fun, felts), 3, results,
                (nbytes(felts) + 16 * 4 * CHUNK, CHUNK * (nch + 1) * GL_PERM[hash_fun]))
        unfused_ms = events_ms(lambda: GC.sponge_digest_felts(GE.encode_rows(rows), hash_fun), 3)
        log(f"    the path the byte-row entry replaces: {unfused_ms:.4f} ms")
        results[f"{sponge}:planes"]["unfused_ms"] = unfused_ms
        compare(sponge, lambda: GC.sponge_digest_rows(rows, hash_fun),
                lambda: GP.sponge_digest_rows(hash_fun, rows), 3, results,
                (nbytes(rows) + 16 * 4 * CHUNK, CHUNK * (nch + 1) * GL_PERM[hash_fun]))
    log(f"  (GL widths: states 4096, compress {CHUNK} -> {CHUNK // 2}, tree {CHUNK} -> 1,"
        f" sponge {CHUNK} cells of {CELL} bytes, {felts.shape[0]} felts)")


def monolith_imad_wide(sass: str) -> dict:
    """IMAD.WIDE (32 x 32 -> 64-bit multiply-adds) a Monolith permutation
    executes, from the SASS of the K5 compression kernel (gl_perm_kernel<1>,
    one permutation a thread): the instructions of its round loop (the
    body between the one backward branch and its target) count once a
    round, the others once.  Address arithmetic is included."""
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "gl_perm_kernel" not in name or "ILi1E" not in name:
            continue
        ops = [(int(a, 16), op, rest) for a, op, rest in MB.SASS_OP.findall(chunk)]
        loops = [(int(m.group(1), 16), a) for a, op, rest in ops if op.startswith("BRA")
                 for m in [re.search(r"0x([0-9a-f]+)", rest)] if m and int(m.group(1), 16) < a]
        wide = [a for a, op, _ in ops if op.startswith("IMAD.WIDE")]
        if len(loops) != 1:
            return {"static": len(wide), "loops": len(loops)}
        lo, hi = loops[0]
        inside = sum(lo <= a <= hi for a in wide)
        return {"outside_loop": len(wide) - inside, "round_loop": inside,
                "per_permutation": len(wide) - inside + GLF.MONOLITH_ROUNDS * inside}
    raise AssertionError("no Monolith compression kernel in the SASS")


# the microbenchmark kernels in the SASS: label -> (a part of the mangled
# name, the instruction classes it must hold, the classes it must not)
MB_SASS = {
    "mul": ("elem_kernelILi0E", ("IMAD",), ()),
    "add": ("elem_kernelILi1E", (), ()),
    "mix": (MB.MIX_KERNEL, ("IMAD",), ()),
    "ilp4": ("elem_kernelILi3E", ("IMAD",), ()),
    "ilp8": ("elem_kernelILi4E", ("IMAD",), ()),
    "conv": ("elem_kernelILi5E", ("I2F", "F2I"), ()),
    "dot64x32": ("dot_wgmma_kernelILi64ELi32E", ("HGMMA",), ("HMMA",)),
    "dot128x128": ("dot_wgmma_kernelILi128ELi128E", ("HGMMA",), ("HMMA",)),
}


def sass_classes(ops: list[str]) -> dict:
    """Counts of the instruction classes the microbenchmarks measure: IMAD
    (integer multiplies: IMAD and IMUL without IMAD.MOV, IMAD.IADD and
    IMAD.SHL, which are moves, adds and shifts on the multiply pipe), I2F
    (I2F and I2FP), F2I, HMMA (mma.sync) and HGMMA (wgmma)."""
    imad = [o for o in ops if o.startswith(("IMAD", "IMUL"))
            and not o.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL"))]
    return {"IMAD": len(imad), "I2F": sum(o.startswith("I2F") for o in ops),
            "F2I": sum(o.startswith("F2I") for o in ops),
            "HMMA": sum(o.startswith("HMMA") for o in ops),
            "HGMMA": sum(o.startswith("HGMMA") for o in ops)}


def top_ops(ops: list[str], n: int) -> dict:
    top: dict = {}
    for o in ops:
        top[o] = top.get(o, 0) + 1
    return dict(sorted(top.items(), key=lambda kv: -kv[1])[:n])


def sass_mix() -> dict:
    """The static instruction mix of the K2 and K6 byte-row kernels
    (cuobjdump -sass of the built library):
    all instructions, the integer multiplies among them (IMAD and its forms,
    without IMAD.MOV, IMAD.IADD and IMAD.SHL, which are moves, adds and
    shifts issued on the multiply pipe) and the most frequent opcodes.  The
    round loops are rolled and the S-box is a called function, which the
    dump lists inside each kernel's body, so the body's mix is close to
    what the kernel executes.  Then the IMAD.WIDE of a Monolith permutation
    (monolith_imad_wide).  Last, for each microbenchmark kernel (MB_SASS),
    its instruction count, sass_classes and most frequent opcodes: M1-M5
    are fully unrolled, so their counts are what a thread executes.
    Returns the microbenchmark kernels' sass_classes by label."""
    sass = MB.cuobjdump_sass(os.path.join(build.build_dir(), build.LIB_NAME))
    mb: dict = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        label = next((k for k, (part, _, _) in MB_SASS.items() if part in name), None)
        if label is not None:
            ops = [op for _, op, _ in MB.SASS_OP.findall(chunk)]
            mb[label] = sass_classes(ops)
            log(f"  microbench {label}: {len(ops)} instructions, {json.dumps(mb[label])},"
                f" most frequent {json.dumps(top_ops(ops, 8))}")
            continue
        if "p2_sponge2_kernel" in name and "ByteRows" in name:
            label = "K2 sponge2 rows (kernel body)"
        elif "gl_sponge8_kernel" in name and "ByteRows" in name:
            core = "monolith" if "ILi1E" in name else "poseidon2"
            label = f"K6 sponge8 rows, {core} core (kernel body)"
        else:
            continue
        ops = [op for _, op, _ in MB.SASS_OP.findall(chunk)]
        muls = [o for o in ops if o.startswith("IMAD")
                and not o.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL"))]
        fma_pipe = [o for o in ops if o.startswith("IMAD")]
        most = top_ops(ops, 6)
        log(f"  {label}: {len(ops)} instructions, integer multiplies {len(muls)}"
            f" ({100 * len(muls) / max(1, len(ops)):.1f} %), all IMAD forms {len(fma_pipe)}"
            f" ({100 * len(fma_pipe) / max(1, len(ops)):.1f} %), most frequent {json.dumps(most)}")
    log(f"  IMAD.WIDE of a Monolith permutation (K5 compression kernel):"
        f" {json.dumps(monolith_imad_wide(sass))}")
    return mb


def phase_small(tmp: str) -> None:
    out = os.path.join(tmp, "small.json")
    argv = [*SMALL_BN254, "--device=cuda", "--check", f"--output={out}"]
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("cspc-torch failed on the small dataset")
    port_s = time.perf_counter() - t0
    args = cli.build_parser().parse_args(argv)
    glob, dset = cli.configs_from_args(args)
    t0 = time.perf_counter()
    want = oracle_proof_input(glob, dset, args.index, args.entropy)
    if load_proof_input(out) != want:
        raise AssertionError("small proof input differs from the oracle")
    log(f"  small proof input equals the oracle (port {port_s:.2f} s, oracle {time.perf_counter() - t0:.2f} s)")


def reset_launches() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0


def check_launches(path: str, also: tuple[str, ...] = ()) -> dict:
    """The counts since reset_launches(): every kernel of the path and of
    `also` launched, and nothing else (no kernel of another path, no
    limb-plane entry)."""
    launches = check_only(path, (*PATH_COUNTERS[path], *also))
    trees = [k for k, cap in MAX_TREE_LAUNCHES.items() if launches.get(k, 0) > cap]
    if trees:
        raise AssertionError(f"{path}: more tree launches than {MAX_TREE_LAUNCHES}: {trees}")
    return launches


def check_only(what: str, allowed: tuple[str, ...]) -> dict:
    """The counts since reset_launches() of the kernels that launched: every
    counter in `allowed` launched, and nothing else."""
    launches = dict(build.LAUNCHES)
    missing = [k for k in allowed if launches[k] < 1]
    stray = [k for k, n in launches.items() if n and k not in allowed]
    if missing or stray:
        raise AssertionError(f"{what}: launches {launches}: missing {missing}, stray {stray}")
    return {k: n for k, n in launches.items() if n}


def phase_full(tmp: str) -> tuple[dict, dict]:
    out = os.path.join(tmp, "full.json")
    argv = ["--field=bn254", "--device=cuda", "--nslots=2", "--log2ncells=19",
            f"--cellsize={CELL}", "--blocksize=65536", "--nsamples=5", "--check",
            f"--output={out}"]
    args = cli.build_parser().parse_args(argv)
    glob, dset = cli.configs_from_args(args)

    reset_launches()
    plain_passes, sampler_passes = [], []
    from_mont = L.from_mont

    def counted_from_mont(a):
        # every plain Montgomery-to-canonical pass (limbs.from_mont, which
        # models/hashing.py::from_mont_layers also runs), by its caller; the
        # circuit checker's pass over the sampled indices (--check) is not
        # the tree's, and the sampler's over its (NL, nSamples) hashes
        # (models/hashing.py::sample_indices) is counted apart
        caller = sys._getframe(1).f_code
        if (caller.co_filename.endswith(os.path.join("models", "hashing.py"))
                and caller.co_name == "sample_indices"):
            sampler_passes.append(tuple(a.shape))
        elif not caller.co_filename.endswith(os.path.join("models", "circuit.py")):
            plain_passes.append(f"{caller.co_filename}:{caller.co_name} {tuple(a.shape)}")
        return from_mont(a)

    L.from_mont = counted_from_mont
    try:
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError("cspc-torch failed on the 1 GB slots")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        L.from_mont = from_mont
    launches = check_launches("bn254", also=("perm",))  # perm: the sampler's two
    if launches["perm"] != 2:
        raise AssertionError(f"bn254: {launches['perm']} perm launches, not the sampler's 2")
    if plain_passes:
        raise AssertionError(f"a plain Montgomery pass ran on the BN254 path: {plain_passes}")
    if sampler_passes != [(L.NL, dset.n_samples)]:
        raise AssertionError(f"bn254: the sampler's plain passes {sampler_passes}, not one over"
                             f" its {(L.NL, dset.n_samples)} hashes")
    log(f"  2 x 1 GB proof input: {wall:.2f} s, launches {launches}, no plain Montgomery pass"
        f" but the sampler's over its {sampler_passes[0]} hashes")

    pi = load_proof_input(out)
    cfg = slot_cfg_from_dataset_cfg(glob, dset, pi.slot_index)
    log_n = dset.n_cells.bit_length() - 1
    idxs = sample_cell_indices(pi.entropy, pi.slot_root, dset.n_cells, dset.n_samples)
    for k, idx in enumerate(idxs):
        cell = gen_fake_cell(CELL, cfg.data_src.seed, idx)
        h = hash_cell_bytes(cell)
        if pi.cell_data[k] != cell_data_to_field_elements(cell):
            raise AssertionError(f"cell data of sample {k} differs")
        if not check_cell_proof(cfg, pi.slot_root, idx, h, pi.merkle_paths[k][:log_n]):
            raise AssertionError(f"Merkle path of sample {k} does not reach slotRoot")
        if any(pi.merkle_paths[k][log_n:]):
            raise AssertionError(f"Merkle path of sample {k} is not zero-padded")
    log_s = (dset.n_slots - 1).bit_length()
    proof = MerkleProof(pi.slot_index, pi.slot_root, pi.slot_proof[:log_s], dset.n_slots)
    if reconstruct_root(proof) != pi.data_set_root:
        raise AssertionError("slotProof does not reach dataSetRoot")
    evaluate_witness(glob, pi, generate_witness(glob, pi))
    log(f"  host checks ok: {len(idxs)} cell hashes and paths, slotProof, witness")

    cfg = slot_cfg_from_dataset_cfg(glob, dset, 0)
    stats = S.StreamingStats()
    t0 = time.perf_counter()
    root = S.streaming_slot_root(cfg, stats=stats)
    warm = time.perf_counter() - t0
    log(f"  warm 1 GB slot-root build: {warm:.4f} s, stats {json.dumps(stats.as_dict())}")
    if pi.slot_index == 0 and root != pi.slot_root:
        raise AssertionError("warm slot root differs")
    log_profile("bn254", lambda: S.streaming_slot_root(cfg))
    return launches, {"pi": pi, "argv": argv, "out": out, "wall": wall}


def phase_small_gl(tmp: str) -> None:
    for hash_fun in HASHES:
        out = os.path.join(tmp, f"small_gl_{hash_fun}.json")
        argv = [f"--hash={hash_fun}", "--device=cuda", *SMALL_GL, "--check", f"--output={out}"]
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"cspc-torch failed on the small {hash_fun} dataset")
        port_s = time.perf_counter() - t0
        args = cli.build_parser().parse_args(argv)
        glob, dset = cli.configs_from_args(args)
        t0 = time.perf_counter()
        want = oracle_proof_input_gl(hash_fun, glob, dset, args.index, GO.int_to_digest(args.entropy))
        oracle_s = time.perf_counter() - t0
        ref = os.path.join(tmp, f"small_gl_{hash_fun}_oracle.json")
        export_proof_input_gl(ref, want)
        with open(out, "rb") as a, open(ref, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"small {hash_fun} proof input differs from the oracle")
        log(f"  {hash_fun}: small proof input equals the oracle's export (port {port_s:.2f} s,"
            f" oracle {oracle_s:.2f} s)")


def load_proof_input_gl(path: str):
    """The Goldilocks JSON export back into a ProofInputGL."""
    from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import ProofInputGL

    with open(path) as f:
        d = json.load(f)

    def dig(v):
        return tuple(int(x) for x in v)

    return ProofInputGL(
        entropy=dig(d["entropy"]), data_set_root=dig(d["dataSetRoot"]),
        slot_index=d["slotIndex"], slot_root=dig(d["slotRoot"]),
        n_slots_per_dataset=d["nSlotsPerDataSet"], n_cells_per_slot=d["nCellsPerSlot"],
        slot_proof=[dig(x) for x in d["slotProof"]],
        cell_data=[[dig(x) for x in cell] for cell in d["cellData"]],
        merkle_paths=[[dig(x) for x in path] for path in d["merklePaths"]],
    )


def host_checks_gl(hash_fun: str, glob, dset, pi) -> None:
    """Each sampled cell's digest and Merkle path, the dataset proof and
    check_proof_input_gl, with the port's oracle."""
    comp = GO.compress_fn(hash_fun)
    cfg = slot_cfg_from_dataset_cfg(glob, dset, pi.slot_index)
    log_n = dset.n_cells.bit_length() - 1
    btd = glob.block_tree_depth
    k = cfg.cells_per_block
    for s in range(dset.n_samples):
        idx = GO.sample_cell_index_gl(hash_fun, pi.entropy, pi.slot_root, dset.n_cells, s + 1)
        cell = gen_fake_cell(CELL, cfg.data_src.seed, idx)
        if pi.cell_data[s] != GO.bytes_to_digests_gl(cell):
            raise AssertionError(f"{hash_fun}: cell data of sample {s} differs")
        path = pi.merkle_paths[s]
        block_root = reconstruct_root(
            MerkleProof(idx % k, GO.digest_bytes(hash_fun, cell), list(path[:btd]), k), comp)
        top = MerkleProof(idx >> btd, block_root, list(path[btd:log_n]), dset.n_cells >> btd)
        if reconstruct_root(top, comp) != pi.slot_root:
            raise AssertionError(f"{hash_fun}: Merkle path of sample {s} does not reach slotRoot")
        if any(d != GO.ZERO_DIGEST for d in path[log_n:]):
            raise AssertionError(f"{hash_fun}: Merkle path of sample {s} is not zero-padded")
    log_s = max(1, (dset.n_slots - 1).bit_length())
    proof = MerkleProof(pi.slot_index, pi.slot_root, list(pi.slot_proof[:log_s]), dset.n_slots)
    if reconstruct_root(proof, comp) != pi.data_set_root:
        raise AssertionError(f"{hash_fun}: slotProof does not reach dataSetRoot")
    check_proof_input_gl(hash_fun, glob, pi)


def profile_root(fn) -> dict:
    """Device time by kernel of one fn() under torch.profiler: the device
    events' durations, grouped, their union (busy), their span, and the
    host wall of that same profiled call (fn() through a device sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def group(name: str) -> str:
        if "p2_tree_kernel" in name or "p2_perm_kernel" in name:
            return "K1 tree and perm"
        if "p2_sponge2_kernel" in name:
            return "K2 sponge2"  # the byte-row entry on the main path
        if "fake_prng_rows_kernel" in name:
            return "K3 fake_prng"
        if "gl_sponge8_kernel" in name:
            return "K6 sponge8"
        # the first template argument is the hash
        if "gl_perm_kernel" in name or "gl_tree_kernel" in name:
            return "K5 mono_perm" if "<1" in name or "ILi1E" in name else "K4 gl_perm"
        return "other: torch passes, copies"

    groups: dict = {}
    other: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = e.time_range.elapsed_us() / 1e3
        g = group(e.name)
        groups[g] = groups.get(g, 0.0) + ms
        if g.startswith("other"):
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + ms
    busy_us, end = 0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3 if spans else 0.0
    top_other = dict(sorted(other.items(), key=lambda kv: -kv[1])[:4])
    return {"busy_ms": busy_us / 1e3, "span_ms": span_ms, "wall_ms": wall_ms,
            "events": len(spans), "ms_by_kernel": groups, "top_other_ms": top_other}


def log_profile(label: str, fn) -> None:
    """Profile one warm slot-root build and log where its device time went.
    Idle is 1 - busy / wall of the profiled call itself; the profiler's
    own host cost is inside that wall, so the share is an upper bound of
    the unprofiled build's."""
    prof = profile_root(fn)
    if prof["events"] == 0:
        log(f"  {label}: torch.profiler saw no device events")
        return
    log(f"  {label}: profiled build: wall {prof['wall_ms']:.3f} ms, {prof['events']} device"
        f" events, busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms device span;"
        f" idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled wall,"
        f" {100 * (1 - prof['busy_ms'] / prof['span_ms']):.1f} % of the device span;"
        f" ms by kernel {json.dumps(prof['ms_by_kernel'])};"
        f" largest others {json.dumps(prof['top_other_ms'])}")


def phase_full_gl(tmp: str, hash_fun: str) -> tuple[dict, dict]:
    """One Goldilocks main path (one hash): its launch counts are set to 0
    just before its CLI run and read just after."""
    out = os.path.join(tmp, f"full_gl_{hash_fun}.json")
    argv = [f"--hash={hash_fun}", "--device=cuda", "--nslots=2", "--log2ncells=19",
            f"--cellsize={CELL}", "--blocksize=65536", "--nsamples=5", "--check",
            f"--output={out}"]
    reset_launches()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError(f"cspc-torch failed on the {hash_fun} 1 GB slots")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(hash_fun)
    log(f"  {hash_fun}: 2 x 1 GB proof input: {wall:.2f} s, launches {launches}")

    glob, dset = cli.configs_from_args(cli.build_parser().parse_args(argv))
    pi = load_proof_input_gl(out)
    host_checks_gl(hash_fun, glob, dset, pi)
    log(f"  {hash_fun}: host checks ok: {dset.n_samples} cell digests and paths, slotProof,"
        " check_proof_input_gl")

    cfg = slot_cfg_from_dataset_cfg(glob, dset, 0)
    stats = S.StreamingStats()
    t0 = time.perf_counter()
    root = S.streaming_slot_root_gl(cfg, hash_fun, stats=stats)
    warm = time.perf_counter() - t0
    log(f"  {hash_fun}: warm 1 GB slot-root build {warm:.4f} s, stats {json.dumps(stats.as_dict())}")
    if pi.slot_index == 0 and root != pi.slot_root:
        raise AssertionError(f"{hash_fun}: warm slot root differs")
    log_profile(hash_fun, lambda: S.streaming_slot_root_gl(cfg, hash_fun))
    return launches, {"argv": argv, "out": out, "wall": wall}


def phase_verifier(run: dict) -> dict:
    """verify_proof_input_device on the clean proof input and on three
    tampered copies; returns the launch counts of the four calls."""
    import dataclasses

    pi = run["pi"]
    glob, _ = cli.configs_from_args(cli.build_parser().parse_args(run["argv"]))
    cell = dataclasses.replace(pi, cell_data=[list(c) for c in pi.cell_data])
    cell.cell_data[0][0] ^= 1
    path = dataclasses.replace(pi, merkle_paths=[list(p) for p in pi.merkle_paths])
    path.merkle_paths[1][2] ^= 1
    proof = dataclasses.replace(pi, slot_proof=list(pi.slot_proof))
    proof.slot_proof[0] ^= 1
    reset_launches()
    for label, case, want in (("clean", pi, True), ("cell felt", cell, False),
                              ("path sibling", path, False), ("slotProof entry", proof, False)):
        t0 = time.perf_counter()
        got = verify_proof_input_device(glob, case)
        wall = time.perf_counter() - t0
        log(f"  {label}: verify_proof_input_device -> {got} in {wall * 1e3:.1f} ms")
        if got != want:
            raise AssertionError(f"device verifier on the {label} proof input: {got}, want {want}")
    launches = check_only("verifier", PATH_COUNTERS["verifier"])
    log(f"  launches {launches}")
    return launches


def timed(fn):
    """(fn()'s result, its wall in seconds through a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sharded(tmp: str, runs: dict) -> None:
    """The sharded proof inputs on a 2 x 2 mesh of shards on cuda:0 against
    phase 5's and 7's exports.  Walls in turns: single-device, sharded,
    sharded, single-device; the launch counts are those of the first
    sharded run."""
    from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
        export_proof_input_gl,
    )

    mesh = PAR.make_mesh(n_cells_shards=2, n_slot_shards=2, devices=["cuda:0"] * 4)
    dev = torch.device("cuda")
    for field in ("bn254", *HASHES):
        run = runs[field]
        args = cli.build_parser().parse_args(run["argv"])
        glob, dset = cli.configs_from_args(args)
        out = os.path.join(tmp, f"sharded_{field}.json")
        if field == "bn254":
            def single():
                return cli.generate(glob, dset, args.index, args.entropy, dev)

            def sharded():
                return PAR.sharded_proof_input(glob, dset, args.index, args.entropy, mesh)
            allowed = (*PATH_COUNTERS["bn254"], "perm")  # perm: the dataset level, sampling
        else:
            def single():
                return cli.generate_gl(field, glob, dset, args.index, args.entropy, dev)

            def sharded():
                return PAR.sharded_gl_proof_input(field, glob, dset, args.index,
                                                  GO.int_to_digest(args.entropy), mesh)
            perm, sponge = PATH_COUNTERS[field][1:]
            allowed = ("prng", perm, sponge, sponge + "_planes")
        _, single_1 = timed(single)
        reset_launches()
        pi, sharded_1 = timed(sharded)
        launches = check_only(field, allowed)
        _, sharded_2 = timed(sharded)
        _, single_2 = timed(single)
        if field == "bn254":
            export_proof_input(out, pi)
            check_circuit_semantics(glob, dset, pi)
            check = "check_circuit_semantics"
        else:
            export_proof_input_gl(out, pi)
            check_proof_input_gl(field, glob, pi)
            check = "check_proof_input_gl"
        with open(out, "rb") as a, open(run["out"], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{field}: the sharded proof input differs from the"
                                     " single-device one")
        log(f"  {field}: mesh {mesh.shape}; walls in turns single-device {single_1:.4f} s,"
            f" sharded {sharded_1:.4f} s, sharded {sharded_2:.4f} s, single-device"
            f" {single_2:.4f} s (the CLI run of phase 5/7: {run['wall']:.2f} s); export equal,"
            f" {check} ok; launches {launches}")


def phase_checkpoint(tmp: str, run: dict) -> None:
    """A 1 GB BN254 slot: one chunk computed and saved, a stop, then the
    resume; the root must equal phase 5's slot root."""
    glob, dset = cli.configs_from_args(cli.build_parser().parse_args(run["argv"]))
    pi = run["pi"]
    cfg = slot_cfg_from_dataset_cfg(glob, dset, pi.slot_index)
    ck = os.path.join(tmp, "checkpoint")
    first, second = S.StreamingStats(), S.StreamingStats()
    t0 = time.perf_counter()
    if S.streaming_slot_root(cfg, stats=first, checkpoint_dir=ck, stop_after_chunks=1) is not None:
        raise AssertionError("checkpoint: the build did not stop after one chunk")
    t1 = time.perf_counter()
    root = S.streaming_slot_root(cfg, stats=second, checkpoint_dir=ck)
    t2 = time.perf_counter()
    if root != pi.slot_root:
        raise AssertionError("checkpoint: the resumed root differs from phase 5's")
    if second.loaded != 1 or second.chunks - second.loaded != 1:
        raise AssertionError(f"checkpoint: resume loaded {second.loaded} of {second.chunks} chunks")
    log(f"  stopped run {t1 - t0:.4f} s (1 chunk computed, save {first.save_s:.4f} s);"
        f" resume {t2 - t1:.4f} s: {second.loaded} chunk loaded ({second.load_s:.4f} s),"
        f" {second.chunks - second.loaded} computed (save {second.save_s:.4f} s); root equals"
        " phase 5's")


def phase_two_processes(tmp: str, run: dict) -> None:
    """Two processes on this card, gloo, one 1 GB slot each (the slots axis
    spans them): both print phase 5's dataset root and write its proof
    input."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dataset = [a for a in run["argv"] if not a.startswith(("--output", "--check"))]
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        cmd = [sys.executable, "-m", "codex_storage_proofs_circuits_tpu_torch.parallel.distributed",
               "--backend=gloo", f"--init-method=tcp://127.0.0.1:{port}", "--world-size=2",
               f"--rank={rank}", *dataset, f"--output={os.path.join(tmp, f'dist_{rank}.json')}"]
        procs.append(subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    want = str(run["pi"].data_set_root)
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  rank {rank}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} exited {p.returncode}: {err[-3000:]}")
        roots = [line.split()[1] for line in out.splitlines() if line.startswith("DATASET_ROOT")]
        if roots != [want]:
            raise AssertionError(f"rank {rank}: dataset root {roots}, phase 5's {want}")
        with open(os.path.join(tmp, f"dist_{rank}.json"), "rb") as a, open(run["out"], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"rank {rank}: the proof input differs from phase 5's")
    log(f"  both ranks: phase 5's dataset root and proof input; two-process wall {wall:.2f} s"
        " (process start, kernel load, build, gloo all_reduce)")


def phase_entry() -> None:
    """entry()'s root against the oracle; dryrun_multichip(8) on one card."""
    fn, args = EN.entry()
    t0 = time.perf_counter()
    root = L.unpack(fn(*args))[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = SlotConfig(cell_size=2048, block_size=65536, n_cells=256, n_samples=1,
                     data_src=DataSource("fake", seed=12345))
    if root != calc_slot_tree(cfg).root:
        raise AssertionError("entry(): the root differs from the oracle's")
    log(f"  entry(): root equals the oracle's ({wall * 1e3:.1f} ms on the card)")
    t0 = time.perf_counter()
    EN.dryrun_multichip(8)
    log(f"  dryrun_multichip(8): {time.perf_counter() - t0:.2f} s")


def host_cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives it: the model name, and the
    vendor, family, model and clock (a virtual machine may hide the name)."""
    fields: dict[str, str] = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first processor's block
            key, _, val = line.partition(":")
            fields[key.strip()] = val.strip()
    return (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')} family"
            f" {fields.get('cpu family', '?')} model {fields.get('model', '?')},"
            f" {fields.get('cpu MHz', '?')} MHz)")


def phase_native(tmp: str, runs: dict, smi: str) -> None:
    """The host C library against the card's path: (a) a cold build, (b) the
    small exports of phases 4 and 6, (c) one whole 1 GB slot of phase 5's
    and of phase 7's datasets: the native root against the device's slot
    root, the native block roots against the device's; (d) no kernel
    launched while the native path ran; (e) the walls."""
    from codex_storage_proofs_circuits_tpu_torch import native as NAT
    from codex_storage_proofs_circuits_tpu_torch.native import build as NB

    cc = os.environ.get("CC", "cc")
    version = subprocess.run([cc, "--version"], capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    err = NB.build_into(os.path.join(tmp, "native_cold"))
    build_s = time.perf_counter() - t0
    if err is not None or not NAT.available():
        raise AssertionError(f"native: the host C library did not build: {err or NAT.build_error()}")
    cpu, threads = host_cpu_model(), NAT._nthreads()
    log(f"  {version}; cold build {build_s:.2f} s; library {NB.build_dir()};"
        f" host CPU {cpu}, os.cpu_count() {os.cpu_count()}, {threads} threads")

    # the device's layers of each 1 GB slot, built before the counts are
    # reset: the root and the 2^14 block roots (depth btd), and the wall of
    # this warm build
    device = {}
    for field in ("bn254", *HASHES):
        glob, dset = cli.configs_from_args(cli.build_parser().parse_args(runs[field]["argv"]))
        pi = runs[field]["pi"] if field == "bn254" else load_proof_input_gl(runs[field]["out"])
        cfg = slot_cfg_from_dataset_cfg(glob, dset, pi.slot_index)
        btd = glob.block_tree_depth
        t0 = time.perf_counter()
        if field == "bn254":
            layers = S.streaming_slot_layers(cfg)
            blocks, root = L.unpack(layers[btd]), L.unpack(layers[-1])[0]
        else:
            layers = S.streaming_slot_layers_gl(cfg, field)
            blocks, root = GH.digests(layers[btd]), GH.digests(layers[-1])[0]
        wall = time.perf_counter() - t0
        if root != pi.slot_root or len(blocks) != dset.n_cells >> btd:
            raise AssertionError(f"native: {field}: the device's layers differ from its export")
        device[field] = {"cfg": cfg, "btd": btd, "blocks": blocks, "root": root, "wall": wall}
        del layers

    reset_launches()
    for label, flags, ref in (
        ("bn254", SMALL_BN254, "small.json"),
        *((h, [f"--hash={h}", *SMALL_GL], f"small_gl_{h}.json") for h in HASHES),
    ):
        out = os.path.join(tmp, f"small_native_{label}.json")
        t0 = time.perf_counter()
        if cli.main([*flags, "--backend=native", "--check", f"--output={out}"]) != 0:
            raise AssertionError(f"native: cspc-torch --backend=native failed on {label}")
        with open(out, "rb") as a, open(os.path.join(tmp, ref), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"native: {label}: the small export differs from {ref}")
        log(f"  {label}: cspc-torch --backend=native ({time.perf_counter() - t0:.2f} s) equals"
            f" the export of phase {4 if label == 'bn254' else 6} byte for byte")

    walls = {}
    for field, dev in device.items():
        cfg, btd = dev["cfg"], dev["btd"]
        t0 = time.perf_counter()
        if field == "bn254":
            data = NAT.fake_cells(cfg.cell_size, cfg.data_src.seed, 0, cfg.n_cells)
            _, big = NAT.slot_tree_from_bytes(data, cfg.cell_size, cfg.cells_per_block)
            del data
            blocks, root = big[0], big[-1][0]
        else:
            layers = NAT.gl_slot_tree_layers(field, cfg.n_cells, cfg.cell_size,
                                             cfg.data_src.seed, btd)
            blocks, root = layers[btd], layers[-1][0]
        walls[field] = time.perf_counter() - t0
        bad = [b for b, (x, y) in enumerate(zip(blocks, dev["blocks"])) if x != y]
        if bad or len(blocks) != len(dev["blocks"]):
            raise AssertionError(f"native: {field}: {len(bad)} block roots differ from the"
                                 f" device's, first block {bad[:1]}")
        if root != dev["root"]:
            raise AssertionError(f"native: {field}: the native slot root differs from the device's")
        log(f"  {field}: {cfg.n_cells * cfg.cell_size >> 20} MiB slot ({cfg.n_cells} cells):"
            f" native root and {len(blocks)} block roots equal the device's; native"
            f" {walls[field]:.2f} s, device (warm build of the same slot's layers)"
            f" {dev['wall']:.4f} s, phase {5 if field == 'bn254' else 7} CLI (2 slots)"
            f" {runs[field]['wall']:.2f} s")
    if any(build.LAUNCHES.values()):
        raise AssertionError(f"native: kernels launched on the native path: {build.LAUNCHES}")
    log("  no kernel launched while the native path ran")
    log("  native walls: " + json.dumps({
        "host_cpu": cpu, "threads": threads, "card": smi, "cc": version, "build_s": build_s,
        "native_s": walls, "device_warm_s": {f: d["wall"] for f, d in device.items()},
        "device_cli_2_slots_s": {f: runs[f]["wall"] for f in device}}))


def phase_tools(tmp: str) -> None:
    """bench_torch.py in its own process (full size), its roots against this
    process's builds of the same slot and its compress rates against the
    device time of the same calls; profile_stages for each path; the sharded
    build on four shards of the card by scaling_bench."""
    out = os.path.join(tmp, "bench_torch_metrics.json")
    torch.cuda.empty_cache()
    start = t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "bench_torch.py", "--out", out],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        log(f"  bench_torch.py stderr: {line}")
    if r.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {r.returncode}")
    lines = r.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} lines, not one JSON line")
    line = json.loads(lines[0])
    log(f"  bench_torch.py: exit 0 in {wall:.2f} s; its line: {lines[0]}")
    with open(out) as f:
        m = json.load(f)

    cfg, _ = BT.slot_config(True, False)
    own = {"bn254": str(S.streaming_slot_root(cfg))}
    for hash_fun in HASHES:
        own[hash_fun] = [str(v) for v in S.streaming_slot_root_gl(cfg, hash_fun)]
    got = {"bn254": m["slot_root"]["slot_root"], "poseidon2": m["gl_slot_root"]["gl_slot_root"],
           "monolith": m["monolith_slot_root"]["monolith_slot_root"]}
    if got != own:
        raise AssertionError(f"bench_torch.py's 1 GB roots {got} differ from this script's {own}")
    log(f"  its three 1 GB roots ({cfg.n_cells} cells of {cfg.cell_size} bytes) equal this"
        " script's streaming builds of the same slot")
    for key, tag in (("slot_root", ""), ("gl_slot_root", "gl_"),
                     ("monolith_slot_root", "monolith_")):
        res = m[key]
        log(f"  {key}: cold {res[tag + 'slot_root_cold_s']:.4f} s, warm"
            f" {res[tag + 'slot_root_wall_s']:.4f} s, stages {json.dumps(res['stages'])}")

    batch, gl_batch = BT.compress_batch(True, False), BT.gl_compress_batch(True)
    x, g = BT.bn254_states(batch, "cuda"), BT.gl_states(gl_batch, "cuda")
    gl = m["gl_compress"]
    rates = (  # name, batch, the bench's rate and its window statistics, the call, reps
        ("bn254", batch, m["compress"]["compress_per_s"], m["compress"],
         lambda: P2C.permutation(x), 20),
        ("poseidon2", gl_batch, gl["gl_compress_per_s"], gl,
         lambda: GC.permutation(g, "poseidon2"), 50),
        ("monolith", gl_batch, gl["monolith_compress_per_s"], gl["monolith_detail"],
         lambda: GC.permutation(g, "monolith"), 100),
    )
    for name, b, rate, detail, fn, reps in rates:
        chain_ms = b / rate * 1e3
        dev_ms = device_ms(fn, reps)
        log(f"  {name} compress: batch {b}, chain {chain_ms:.5f} ms a call ({rate:.6g}/s; min"
            f" {detail['per_iter_min_s'] * 1e3:.5f} ms, spread {detail['spread']:.4f},"
            f" {detail['iters']} calls a window), device_ms {dev_ms:.5f} ms"
            f" ({b / dev_ms * 1e3:.6g}/s); chain / device {chain_ms / dev_ms:.4f}")
        if chain_ms < 0.95 * dev_ms:
            raise AssertionError(f"{name}: the bench's chain ({chain_ms:.5f} ms) beats the"
                                 f" kernel's device time ({dev_ms:.5f} ms) by more than 5 %")
    extra = line["extra"]
    log(f"  consistency: {extra['consistency']}; pipeline_efficiency bn254"
        f" {extra['bn254_pipeline_efficiency']:.4f}, gl {extra['gl_pipeline_efficiency']:.4f},"
        f" monolith {extra['monolith_pipeline_efficiency']:.4f}")

    for argv in ([], ["--gl"], ["--gl", "--hash=monolith"]):
        t0 = time.perf_counter()
        PS.main(argv)
        log(f"  profile_stages {' '.join(argv) or '(bn254)'}: {time.perf_counter() - t0:.2f} s")

    scaling = os.path.join(tmp, "scaling_metrics_torch.json")
    t0 = time.perf_counter()
    SB.main(["--device=cuda", "--n-devices=4", "--out", scaling])
    with open(scaling) as f:
        summary = json.load(f)
    for field, rows in summary["results"].items():
        if [row["devices"] for row in rows] != [1, 2, 4] or len({row["root"] for row in rows}) != 1:
            raise AssertionError(f"scaling_bench: {field}: rows {rows}")
    log(f"  scaling_bench: {time.perf_counter() - t0:.2f} s; the 1, 2 and 4-shard meshes give one"
        f" dataset root a field; caveat: {summary['caveat']}")
    log(f"  phase 14: {time.perf_counter() - start:.2f} s")


# launch counter -> the tools' variants of its kernel, the one whose numbers
# the kernels line reports first
MB_VARIANTS = {"mb_mul": ("mul",), "mb_add": ("add",), "mb_mix": ("mix",),
               "mb_ilp": ("ilp8", "ilp4"), "mb_conv": ("conv",),
               "mb_dot": ("dot64x32", "dot128x128")}


def op_bound_ms(cls: str, count: float) -> float:
    """The least time of `count` instructions of class `cls` (flops for the
    tensor cores, 2 a MAC) at the card's peak rate for them at the maximum
    SM clock."""
    if cls == "tc":
        return count / (2 * SMS * MB.TC_MACS_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    return count / (SMS * MB.PEAK_PER_CLOCK[cls] * SM_CLOCK_HZ) * 1e3


def clock_under_load(fn, seconds: float = 1.0) -> str:
    """The SM clock and power draw nvidia-smi reads halfway through
    `seconds` of back-to-back fn() calls (the host blocks on the full
    launch queue, so the card stays busy)."""
    seen: dict = {}

    def sample():
        time.sleep(seconds / 2)
        seen["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    t = threading.Thread(target=sample)
    t.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
    torch.cuda.synchronize()
    t.join()
    return seen["smi"]


def phase_microbench(results: dict, sass: dict) -> dict:
    """The microbenchmark kernels M1-M6: the two tools with their default
    variants (the main path of this phase: launches counted), each variant
    against its plain version at the tools' shapes, the rate checks and the
    SASS guard.  Returns the tools' launch counts."""
    start = time.perf_counter()
    missing = {label: [c for c in need if not sass.get(label, {}).get(c)]
               for label, (_, need, _) in MB_SASS.items()}
    missing = {k: v for k, v in missing.items() if v}
    if missing:
        raise AssertionError(f"microbench: the SASS lacks the instructions measured: {missing}")
    held = {label: [c for c in forbid if sass.get(label, {}).get(c)]
            for label, (_, _, forbid) in MB_SASS.items()}
    held = {k: v for k, v in held.items() if v}
    if held:
        raise AssertionError(f"microbench: the SASS holds instructions it must not: {held}")
    log("  SASS guard: IMAD in mul, mix, ilp4, ilp8; I2F and F2I in conv; HGMMA and no HMMA"
        " in both dots")

    tool: list = []
    reset_launches()
    MB.main([], tool)
    MB2.main([], tool)
    launches = check_only("microbench", PATH_COUNTERS["microbench"])
    log(f"  the tools' run: launches {launches}")

    a16, b16 = MB.u32_inputs(16, "cuda")
    a12, b12 = MB.u32_inputs(12, "cuda")
    elem = {  # variant: kernel, plain version, u32 words an element it must move
        "mul": (lambda: MBC.mul(a16, b16), lambda: MBP.mul(a16, b16), 3),
        "add": (lambda: MBC.add(a16, b16), lambda: MBP.add(a16, b16), 3),
        "mix": (lambda: MBC.mix(a16, b16), lambda: MBP.mix(a16, b16), 3),
        "ilp4": (lambda: MBC.ilp(a12, b12, 4), lambda: MBP.ilp(a12, b12, 4), 3),
        "ilp8": (lambda: MBC.ilp(a12, b12, 8), lambda: MBP.ilp(a12, b12, 8), 3),
        "conv": (lambda: MBC.conv(a12, b12), lambda: MBP.conv(a12, b12), 2),  # b is not read
    }
    by_name = {r["name"]: r for r in tool}
    for name, (kernel, plain, words) in elem.items():
        got = kernel()
        torch.cuda.synchronize()
        want = None

        def run_plain(plain=plain):
            nonlocal want
            want = plain()

        plain_ms = events_ms(run_plain, 1, warmup=False)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if got.shape != want.shape or got.dtype != want.dtype or err != 0:
            raise AssertionError(f"microbench {name}: kernel and plain version disagree"
                                 f" (max abs err {err})")
        by_name[name].update(max_abs_err=err, plain_ms=plain_ms, library_ms=None,
                             n_bytes=words * 4 * a16.numel())
        log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err} (bitwise), plain"
            f" {plain_ms:.1f} ms")

    for name, (m, k, n_dots) in MB2.DOTS.items():
        a, w = MB2.dot_inputs(m, k, "cuda")
        got = MBC.dot(a, w, n_dots)
        torch.cuda.synchronize()
        want = None

        def run_plain(a=a, w=w, n_dots=n_dots):
            nonlocal want
            want = MBP.dot(a, w, n_dots)

        plain_ms = events_ms(run_plain, 1, warmup=False)
        diff = (got - want).abs()
        err = float(diff.max().item())
        rel = float((diff / want.abs().clamp_min(1.0)).max().item())
        if got.shape != want.shape or not bool((diff <= MBC.DOT_RTOL * want.abs()).all()):
            raise AssertionError(f"microbench {name}: kernel and plain version disagree"
                                 f" (max abs err {err}, max rel err {rel:.3g} > {MBC.DOT_RTOL})")
        library_ms = device_ms(lambda: [torch.matmul(w, a) for _ in range(n_dots)], 10)
        by_name[name].update(max_abs_err=err, plain_ms=plain_ms, library_ms=library_ms,
                             n_bytes=nbytes(a, w, got))
        log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err} (max rel {rel:.3g}, within"
            f" {MBC.DOT_RTOL}), plain {plain_ms:.1f} ms, {n_dots} x torch.matmul (bf16 out)"
            f" {library_ms:.4f} ms")

    pipes = by_name["mix"]["pipes"]
    log(f"  mix: its SASS's integer instructions an element by the pipes that must issue them"
        f" {pipes}: bounds " + ", ".join(f"{c} {op_bound_ms(c, pipes[c] * a16.numel()):.6f} ms"
                                         for c in pipes))
    log(f"  rates at the maximum SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz, {SMS} SMs:")
    above = []
    for name, r in by_name.items():
        mem_ms = r["n_bytes"] / MEM_BYTES_PER_S * 1e3
        ops_ms = op_bound_ms(r["class"], r["count"])
        r.update(bound_ms=max(mem_ms, ops_ms), bound_by="bytes" if mem_ms >= ops_ms else "operations")
        share = ops_ms / r["ms"]
        if r["class"] == "tc":
            peak = 2 * SMS * MB.TC_MACS_PER_CLOCK * SM_CLOCK_HZ
            log(f"    {name}: {r['ms']:.6f} ms, {r['tflops']:.2f} TFLOP/s of the bf16 tensor cores'"
                f" {peak / 1e12:.2f} ({100 * share:.1f} %); bound {r['bound_ms']:.6f} ms"
                f" by {r['bound_by']}; {MB2.DOTS[name][2]} x torch.matmul {r['library_ms']:.4f} ms"
                f" ({r['count'] / r['library_ms'] / 1e9:.2f} TFLOP/s)")
        else:
            rate = r["count"] / (r["ms"] * 1e-3) / (SMS * SM_CLOCK_HZ)
            log(f"    {name}: {r['ms']:.6f} ms, {r['class']} {rate:.2f} a clock an SM of"
                f" {MB.PEAK_PER_CLOCK[r['class']]} ({100 * share:.1f} %); bound"
                f" {r['bound_ms']:.6f} ms by {r['bound_by']}")
        if share > 1.05:
            above.append(name)
    # M6 in steady state: the time of twice the tools' products less that
    # of the tools' count (a call of no products still reads A and W and
    # writes the output, and part of that overlaps the products of a longer
    # call, so it is not subtracted), against the tensor cores' MACs a
    # clock.  Logged only: a difference of two times, it is too noisy to
    # check.
    for name, (m, k, n_dots) in MB2.DOTS.items():
        a, w = MB2.dot_inputs(m, k, "cuda")
        times = {n: device_ms(lambda n=n: MBC.dot(a, w, n), 20) for n in (0, n_dots, 2 * n_dots)}
        macs = m * k * a.shape[1] * n_dots
        rate = 2 * macs / ((times[2 * n_dots] - times[n_dots]) * 1e-3)
        share = rate / 2 / (SMS * SM_CLOCK_HZ) / MB.TC_MACS_PER_CLOCK
        walls = ", ".join(f"{n} products {t:.6f} ms" for n, t in times.items())
        log(f"  {name} in steady state: {walls}: {n_dots} more products at"
            f" {rate / 1e12:.2f} TFLOP/s, {share * MB.TC_MACS_PER_CLOCK:.1f} MACs a clock an SM"
            f" ({100 * share:.1f} % of {MB.TC_MACS_PER_CLOCK} at {SM_CLOCK_HZ / 1e6:.0f} MHz)")
    loaded = clock_under_load(lambda: MBC.mul(a16, b16))
    load_hz = float(loaded.split()[0]) * 1e6
    log(f"  SM clock and power draw under M1 back to back: {loaded} (maximum SM clock"
        f" {SM_CLOCK_HZ / 1e6:.0f} MHz)")
    for name in ("mul", "ilp8"):
        per_s = by_name[name]["count"] / (by_name[name]["ms"] * 1e-3) / SMS
        rate = per_s / SM_CLOCK_HZ
        log(f"  u32 multiply rate, {name}: {rate:.2f} a clock an SM at the maximum SM clock"
            f" ({per_s / load_hz:.2f} at the clock under load); bound() assumes"
            f" IMAD_PER_CLOCK = {IMAD_PER_CLOCK} ({100 * rate / IMAD_PER_CLOCK:.1f} %)")
    if above:
        raise AssertionError(f"microbench: above 105 % of their peak (work removed?): {above}")

    for counter, variants in MB_VARIANTS.items():
        r = by_name[variants[0]]
        results[counter] = {
            "max_abs_err": max(by_name[v]["max_abs_err"] for v in variants),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
    log(f"  phase 15: {time.perf_counter() - start:.2f} s")
    return launches


def main() -> int:
    global SM_CLOCK_HZ
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    SM_CLOCK_HZ = float(clock) * 1e6
    log(f"[1] device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"max SM clock {clock} MHz")
    log(smi)

    t0 = time.perf_counter()
    build.load()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s in {build.build_dir()}")
    with open(os.path.join(build.build_dir(), "nvcc.log")) as f:
        for line in f:
            if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma")):
                log("  " + line.strip())
    mb_sass = sass_mix()

    log("[3] kernels against their plain versions")
    results: dict = {}
    phase_kernels(results)

    with tempfile.TemporaryDirectory() as tmp:
        log("[4] BN254: small main path against the oracle")
        phase_small(tmp)
        log("[5] BN254: full-width main path: 2 slots of 1 GB")
        runs = {}
        launches = {}
        launches["bn254"], runs["bn254"] = phase_full(tmp)
        log("[6] Goldilocks: small main path against the oracle, both hashes")
        phase_small_gl(tmp)
        log("[7] Goldilocks: full-width main path: 2 slots of 1 GB, each hash")
        for hash_fun in HASHES:
            launches[hash_fun], runs[hash_fun] = phase_full_gl(tmp, hash_fun)
        log("[8] device verifier on the 2 x 1 GB BN254 proof input")
        launches["verifier"] = phase_verifier(runs["bn254"])
        log("[9] sharded proof inputs, 2 x 1 GB, a 2 x 2 mesh of shards on one card")
        phase_sharded(tmp, runs)
        log("[10] checkpoint resume of a 1 GB BN254 slot")
        phase_checkpoint(tmp, runs["bn254"])
        log("[11] two processes on the card (gloo), one 1 GB slot each")
        phase_two_processes(tmp, runs["bn254"])
        log("[12] entry twins")
        phase_entry()
        log("[13] the host C library (native/) against the card: small exports, 1 GB slot roots")
        phase_native(tmp, runs, smi)
        log("[14] the port's measurement tools: bench_torch.py, profile_stages, scaling_bench")
        phase_tools(tmp)
    log("[15] the microbenchmark kernels M1-M6: the tools, plain versions, rates against peaks")
    launches["microbench"] = phase_microbench(results, mb_sass)

    for key in ("sponge2:planes", "gl_sponge8:planes", "mono_sponge8:planes"):
        r = results[key]
        log(f"  {key}: kernel {r['ms']:.4f} ms, with the plain passes before it"
            f" {r['unfused_ms']:.4f} ms; byte-row entry {results[key.split(':')[0]]['ms']:.4f} ms")
    r = results["p2_tree"]
    log(f"  p2_tree: chunk tree by the subtree entry {r['ms']:.4f} ms (bound {r['bound_ms']:.4f},"
        f" {100 * r['bound_ms'] / r['ms']:.1f} %), by {CHUNK.bit_length() - 1} per-layer launches"
        f" and the plain pass {r['per_layer_ms']:.4f} ms; main path: chunk cut"
        f" {r['chunk_cut_ms']:.4f} ms, frontier to the root {r['frontier_ms']:.4f} ms")
    for key in ("gl_perm", "mono_perm"):
        r, lay = results[key], results[f"{key}:layer"]
        log(f"  {key}: chunk tree by the subtree entry {r['ms']:.4f} ms (bound {r['bound_ms']:.4f},"
            f" {100 * r['bound_ms'] / r['ms']:.1f} %), by {CHUNK.bit_length() - 1} per-layer"
            f" launches {r['per_layer_ms']:.4f} ms; widest layer {lay['ms']:.4f} ms (bound"
            f" {lay['bound_ms']:.4f}, {100 * lay['bound_ms'] / lay['ms']:.1f} %)")
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        r = results[key]
        path = next(p for p, keys in PATH_COUNTERS.items() if key in keys)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[path][key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
