"""The command line of the port: `cspc-torch`.

The flag surface and defaults of the JAX package's `cspc-tpu`
(codex_storage_proofs_circuits_tpu/utils/cli.py, itself mirroring the
reference cli.nim:80-105), with `--device` besides.  Both fields:
goldilocks (the reference's default) with `--hash=poseidon2` or
`--hash=monolith`, and bn254 with Poseidon2.

`--backend` takes the JAX CLI's choices, so that the scripts of workflow/
drive either CLI unchanged:
  - oracle: the port's pure-Python oracle on the host (no device);
  - auto (the default) and tpu: the port's device path on `--device`
    (cuda by default; tpu is the JAX CLI's name for its accelerator path);
  - native: the port's threaded host C library (native/, built at first
    use with $CC into build/native/; CSPC_NATIVE_THREADS sets its
    threads), no device; exits non-zero when the library does not build.

Example:
    cspc-torch -v --nslots=5 --ncells=256 --nsamples=5 --hash=monolith \\
               --output=input.json --circom=proof_main.circom --check
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..oracle.dataset import DataSetConfig, GlobalConfig
from ..oracle.slot import DataSource

# slots of at least this many bytes stream through the device in chunks
STREAMING_SLOT_BYTES = 1 << 26


def _ceiling_log2(x: int) -> int:
    # misc.nim:18-22 convention: ceilingLog2(0) = -1
    if x == 0:
        return -1
    return (x - 1).bit_length()


def _check_power_of_two(x: int, what: str) -> int:
    if x <= 0 or x & (x - 1):
        raise SystemExit(f"`{what}` is expected to be a power of 2 (got {x})")
    return x


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cspc-torch",
        description="Codex storage-proof input generator on PyTorch/CUDA",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--depth", type=int, default=32,
                   help="maximum depth of the slot tree (eg. 32)")
    p.add_argument("-N", "--maxslots", type=int, default=256,
                   help="maximum number of slots (eg. 256)")
    p.add_argument("-c", "--cellsize", type=int, default=2048,
                   help="cell size in bytes (eg. 2048)")
    p.add_argument("-b", "--blocksize", type=int, default=65536,
                   help="block size in bytes (eg. 65536)")
    p.add_argument("-s", "--nslots", type=int, default=11,
                   help="number of slots in the dataset (eg. 13)")
    p.add_argument("-n", "--nsamples", type=int, default=5,
                   help="number of samples we prove (eg. 100)")
    p.add_argument("-e", "--entropy", type=int, default=1234567,
                   help="external randomness (eg. 1234567)")
    p.add_argument("-S", "--seed", type=int, default=12345,
                   help="seed to generate the fake data (eg. 12345)")
    p.add_argument("-f", "--file", type=str, default=None,
                   help='slot data file base name ("slotdata" means "slotdata5.dat" for slot 5)')
    p.add_argument("-i", "--index", type=int, default=0,
                   help="index of the slot (within the dataset) we prove")
    p.add_argument("-k", "--log2ncells", type=int, default=None,
                   help="log2 of the number of cells inside this slot (eg. 10)")
    p.add_argument("-K", "--ncells", type=int, default=256,
                   help="number of cells inside this slot (power of two)")
    p.add_argument("-o", "--output", type=str, default=None,
                   help="JSON file into which we write the proof input")
    p.add_argument("-C", "--circom", type=str, default=None,
                   help="circom main component to create with these parameters")
    p.add_argument("-F", "--field", type=str, default="goldilocks",
                   choices=["bn254", "goldilocks"],
                   help="the underlying field")
    p.add_argument("-H", "--hash", type=str, default="poseidon2",
                   choices=["poseidon2", "monolith"],
                   help="the hash function to use")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "oracle", "tpu", "native"],
                   help="compute path: oracle = the pure-Python oracle on the host; auto and "
                        "tpu = the device path on --device (tpu is cspc-tpu's name for its "
                        "accelerator path); native = the threaded host C library (native/)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the device path (cuda, cuda:N or cpu; default cuda)")
    p.add_argument("--check", action="store_true",
                   help="after generation, check the proof input against the circuit's "
                        "semantics (bn254: check_circuit_semantics; goldilocks: "
                        "check_proof_input_gl)")
    return p


def configs_from_args(args) -> tuple[GlobalConfig, DataSetConfig]:
    n_cells = args.ncells
    if args.log2ncells is not None:
        n_cells = 1 << args.log2ncells
    _check_power_of_two(args.cellsize, "cellSize")
    _check_power_of_two(args.blocksize, "blockSize")
    _check_power_of_two(n_cells, "nCells")
    glob = GlobalConfig(
        max_depth=args.depth,
        max_log2_n_slots=_ceiling_log2(args.maxslots),
        cell_size=args.cellsize,
        block_size=args.blocksize,
    )
    if args.file is not None:
        src = DataSource("file", filename=args.file)
    else:
        src = DataSource("fake", seed=args.seed)
    dset = DataSetConfig(
        n_slots=args.nslots,
        n_cells=n_cells,
        n_samples=args.nsamples,
        data_src=src,
    )
    return glob, dset


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device={name}: no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device={name}: only cuda and cpu are supported")
    return device


def _streams(glob, dset) -> bool:
    """Slots of STREAMING_SLOT_BYTES or more with more than one block
    stream through the device in chunks; small ones batch every slot."""
    slot_bytes = glob.cell_size * dset.n_cells
    return slot_bytes >= STREAMING_SLOT_BYTES and dset.n_cells > glob.cells_per_block


def generate(glob, dset, slot_index: int, entropy: int, device, verbose: bool = False):
    """The BN254 proof input on `device`."""
    from ..models import proof_input as PI

    if _streams(glob, dset):
        if verbose:
            print(f"streaming build ({glob.cell_size * dset.n_cells >> 20} MB/slot)")
        return PI.generate_proof_input_streaming(glob, dset, slot_index, entropy, device=device)
    return PI.generate_proof_input(glob, dset, slot_index, entropy, device=device)


def generate_gl(hash_fun: str, glob, dset, slot_index: int, entropy: int, device,
                verbose: bool = False):
    """The Goldilocks proof input on `device` (entropy as intToDigest)."""
    from ..models import gl_proof_input as GPI
    from ..oracle.goldilocks import int_to_digest

    args = (hash_fun, glob, dset, slot_index, int_to_digest(entropy))
    if _streams(glob, dset):
        if verbose:
            print(f"streaming build ({glob.cell_size * dset.n_cells >> 20} MB/slot)")
        return GPI.generate_proof_input_gl_streaming(*args, device=device)
    return GPI.generate_proof_input_gl(*args, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.field == "bn254" and args.hash != "poseidon2":
        raise SystemExit(f"hash `{args.hash}` is not available over bn254")
    if not (0 <= args.index < args.nslots):
        raise SystemExit(
            f"slot index {args.index} out of range (dataset has {args.nslots} slots)"
        )
    if args.backend == "native":
        from .. import native

        if not native.available():
            raise SystemExit(f"--backend=native: the host C library did not build:"
                             f" {native.build_error()}")
    device = None if args.backend in ("oracle", "native") else _device(args.device)
    glob, dset = configs_from_args(args)

    if args.verbose:
        print(f"field      = {args.field}")
        print(f"hash func. = {args.hash}")
        print(f"backend    = {args.backend}")
        print(f"device     = {device}")
        print(f"maxDepth   = {glob.max_depth}")
        print(f"maxSlots   = {1 << glob.max_log2_n_slots}")
        print(f"cellSize   = {glob.cell_size}")
        print(f"blockSize  = {glob.block_size}")
        print(f"nSamples   = {dset.n_samples}")
        print(f"entropy    = {args.entropy}")
        print(f"slotIndex  = {args.index}")
        print(f"nCells     = {dset.n_cells}")
        print(f"dataSource = {dset.data_src}")

    if args.circom is None and args.output is None:
        print("nothing to do!")
        print("use --help for getting a list of options")
        return 0

    if args.circom is not None:
        from ..utils.circom import write_circom_main_component

        print(f"writing circom main component into `{args.circom}`")
        write_circom_main_component(args.circom, glob, dset)

    if args.output is not None:
        print(f"writing proof input into `{args.output}`...")
        t0 = time.time()
        if args.field == "goldilocks":
            from ..oracle.goldilocks_pipeline import check_proof_input_gl, export_proof_input_gl

            if device is None:
                from ..oracle.goldilocks import int_to_digest

                if args.backend == "native":
                    from ..native import generate_proof_input_gl_native as gen
                else:
                    from ..oracle.goldilocks_pipeline import generate_proof_input_gl as gen
                pi = gen(args.hash, glob, dset, args.index, int_to_digest(args.entropy))
            else:
                pi = generate_gl(args.hash, glob, dset, args.index, args.entropy, device,
                                 args.verbose)
            export_proof_input_gl(args.output, pi)
            if args.verbose:
                print(f"generated in {time.time() - t0:.3f}s")
            if args.check:
                check_proof_input_gl(args.hash, glob, pi)
                print("circuit semantics check: OK")
        else:
            from ..models.circuit import check_circuit_semantics
            from ..utils.json_export import export_proof_input

            if device is None:
                if args.backend == "native":
                    from ..native import generate_proof_input_native as gen
                else:
                    from ..oracle.sampling import generate_proof_input as gen
                pi = gen(glob, dset, args.index, args.entropy)
            else:
                pi = generate(glob, dset, args.index, args.entropy, device, args.verbose)
            export_proof_input(args.output, pi)
            if args.verbose:
                print(f"generated in {time.time() - t0:.3f}s")
            if args.check:
                check_circuit_semantics(glob, dset, pi)
                print("circuit semantics check: OK")

    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
