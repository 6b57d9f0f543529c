#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (codex_storage_proofs_circuits_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels of csrc/ (build seconds, ptxas report);
  3. each kernel against its plain torch version on the card, bitwise, at
     the shapes the main path gives it (one 2^16-cell chunk of 2048-byte
     cells), with the times of both;
  4. the port CLI on a small dataset (5 slots x 256 cells), which must equal
     the pure-Python oracle exactly;
  5. the port CLI on two 1 GB fake-data slots (2^19 cells of 2048 bytes),
     the streaming path, checked on the host: cell hashes, Merkle paths,
     the dataset proof, the witness evaluator, and the kernels' launch
     counts from that run; then one warm 1 GB slot-root build, timed.

Prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Any failed check raises: the exit code is then non-zero and there is no
result line.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from codex_storage_proofs_circuits_tpu.fields import bn254
from codex_storage_proofs_circuits_tpu.models.data import gen_fake_cells
from codex_storage_proofs_circuits_tpu.models.witness import evaluate_witness, generate_witness
from codex_storage_proofs_circuits_tpu.oracle.dataset import slot_cfg_from_dataset_cfg
from codex_storage_proofs_circuits_tpu.oracle.merkle import MerkleProof, reconstruct_root
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input as oracle_proof_input
from codex_storage_proofs_circuits_tpu.oracle.sampling import sample_cell_indices
from codex_storage_proofs_circuits_tpu.oracle.slot import (
    cell_data_to_field_elements,
    check_cell_proof,
    gen_fake_cell,
    hash_cell_bytes,
)
from codex_storage_proofs_circuits_tpu.utils.json_export import load_proof_input
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.ops import encode as E
from codex_storage_proofs_circuits_tpu_torch.ops import fake_prng as F
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as L
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as P2C
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as P2
from codex_storage_proofs_circuits_tpu_torch.utils import cli

CHUNK = S.DEFAULT_CHUNK_CELLS  # cells per streaming chunk on the main path
CELL = 2048
SEED = 12345
KERNELS = {
    "perm": ("poseidon2_bn254_perm", "codex_storage_proofs_circuits_tpu_torch/csrc/poseidon2_bn254.cu",
             "codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py:297"),
    "sponge2": ("poseidon2_bn254_sponge2", "codex_storage_proofs_circuits_tpu_torch/csrc/poseidon2_bn254.cu",
                "codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py:324"),
    "prng": ("fake_prng_rows", "codex_storage_proofs_circuits_tpu_torch/csrc/fake_prng.cu",
             "codex_storage_proofs_circuits_tpu/ops/fake_prng.py:217"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, kernel, plain, reps: int, results: dict) -> None:
    """Kernel against plain version on the same inputs: bitwise equal, both timed."""
    got = kernel()
    torch.cuda.synchronize()
    want = None

    def run_plain():
        nonlocal want
        want = plain()

    plain_ms = cuda_ms(run_plain, 1)  # one run: the plain versions take seconds
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    ms = cuda_ms(kernel, reps)
    log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.1f} ms")
    if got.shape != want.shape or err != 0:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    r = results.setdefault(name, {"max_abs_err": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r.update(ms=ms, plain_ms=plain_ms)


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
    )

    # K3: one main-path chunk of fake cells, and a few cells against the
    # host generator
    s1, s2 = F.fake_seed_bases(SEED, 0, dev)
    compare(
        "prng",
        lambda: F.gen_rows(s1, s2, CELL, CHUNK),
        lambda: F.gen_rows_plain(*F.seed_planes(s1, s2, CHUNK), CELL),
        20,
        results,
    )
    rows = F.gen_rows(s1, s2, CELL, CHUNK)
    host = gen_fake_cells(CELL, SEED, np.arange(8))
    if not np.array_equal(rows[:, :8].T.cpu().numpy(), host):
        raise AssertionError("K3 disagrees with models.data.gen_fake_cells")
    log("  prng: first 8 cells equal models.data.gen_fake_cells")

    # K2: the sponge over that chunk's encoded cells (34 blocks of 2 felts)
    blocks = P2.pad_felts_rate2(H.to_mont_stack(E.encode_rows(rows)))
    compare(
        "sponge2",
        lambda: P2C.sponge2_absorb(blocks),
        lambda: P2.sponge2_absorb(blocks),
        3,
        results,
    )


def phase_small(tmp: str) -> None:
    out = os.path.join(tmp, "small.json")
    argv = ["--field=bn254", "--device=cuda", "--nslots=5", "--ncells=256",
            "--check", f"--output={out}"]
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


def phase_full(tmp: str) -> dict:
    out = os.path.join(tmp, "full.json")
    argv = ["--field=bn254", "--device=cuda", "--nslots=2", "--log2ncells=19",
            f"--cellsize={CELL}", "--blocksize=65536", "--nsamples=5", "--check",
            f"--output={out}"]
    args = cli.build_parser().parse_args(argv)
    glob, dset = cli.configs_from_args(args)

    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("cspc-torch failed on the 1 GB slots")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"  2 x 1 GB proof input: {wall:.2f} s, launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")

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

    stats = S.StreamingStats()
    t0 = time.perf_counter()
    root = S.streaming_slot_root(slot_cfg_from_dataset_cfg(glob, dset, 0), stats=stats)
    warm = time.perf_counter() - t0
    log(f"  warm 1 GB slot-root build: {warm:.4f} s, stats {json.dumps(stats.as_dict())}")
    if pi.slot_index == 0 and root != pi.slot_root:
        raise AssertionError("warm slot root differs")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[1] device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    build.load()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s in {build.build_dir()}")
    with open(os.path.join(build.build_dir(), "nvcc.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())

    log("[3] kernels against their plain versions")
    results: dict = {}
    phase_kernels(results)

    with tempfile.TemporaryDirectory() as tmp:
        log("[4] small main path against the oracle")
        phase_small(tmp)
        log("[5] full-width main path: 2 slots of 1 GB")
        launches = phase_full(tmp)

    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        r = results[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
