"""Rates of u32 multiply, add and Montgomery-step chains on the card.

The twin of tools/microbench.py: its kernels M1 (mul: a = a * b; b = b +
a), M2 (add: a = a + b; b = b ^ a) and M3 (mix: a Montgomery step's 2
products and 13 adds, shifts and logic ops), 512 op groups an element (128
for mix), as the hand-written kernels of csrc/microbench.cu
(ops/microbench_cuda.py).  The inputs are the JAX tool's: a in [0, 2^16)
and b in [1, 2^16), (16, 512 x 64) uint32 from numpy's default_rng(0).

    python3 -m tools_torch.microbench [mul|add|mix ...] [--device=cuda|cpu]

from the root of the checkout (default: mul add mix; an unknown name
exits non-zero).  On the card it prints the card's name and power limit
first, then one line a kernel: its device time (kernels/timing.device_ms),
the JAX tool's Tops/s (u32), and the rate per SM per clock of the
instructions that bound the kernel, at the card's maximum SM clock
(nvidia-smi clocks.max.sm), beside their peak (PEAK_PER_CLOCK).
--device=cpu runs the plain versions once each, timed on the host clock;
without a card --device=cuda fails.  tools_torch/microbench2.py shares
this module's helpers.
"""

from __future__ import annotations

import argparse
import functools
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.kernels.timing import device_ms
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
from codex_storage_proofs_circuits_tpu_torch.ops.microbench_plain import COLS, REPS, ROWS, TILES

# Peak rates an SM a clock of the instructions that bound the kernels, for
# compute capability 9.0 (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions): 32-bit integer multiply and multiply-add
# (IMAD) 64; 32-bit integer add, shift and logic 64 (LOP3 only on the
# integer ALU; an add may also issue on the multiply pipe); both integer
# pipes together 128; type conversions 16 (F2I; ptxas makes an int ->
# float conversion I2FP, which issues faster).
PEAK_PER_CLOCK = {"imad": 64, "alu": 64, "int": 128, "cvt": 16}
# The tensor cores a clock: 4 an SM of 512 dense bf16 MACs (the data
# sheet's 989 TFLOP/s is 132 SMs x 2048 MACs x 2 flops at 1830 MHz; their
# peak is taken at the card's maximum SM clock, as the integer pipes').
TC_MACS_PER_CLOCK = 2048
TIMED_CALLS = 20  # calls a device_ms window

# Integer instructions by the pipes that can issue them (compute capability
# 9.0): products only the multiply pipe (IMAD, IMUL and their forms but
# EITHER_PIPE); logic, LEA, funnel shifts, compares, selects and byte
# permutes only the integer ALU (ALU_ONLY); adds, moves and shifts by a
# constant either (IADD3 on the ALU, IMAD.IADD, IMAD.MOV and IMAD.SHL on
# the multiply pipe).
ALU_ONLY = ("LOP", "LEA", "SHF", "ISETP", "SEL", "PRMT", "IABS", "IMNMX", "BMSK", "BREV",
            "FLO", "POPC")
EITHER_PIPE = ("IADD3", "IMAD.IADD", "IMAD.MOV", "IMAD.SHL")
# an instruction of a cuobjdump -sass listing: address, opcode, operands
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
MIX_KERNEL = "elem_kernelILi2E"  # M3's part of its mangled name in the SASS

# name: (kernel, the JAX tool's ops an element for its Tops/s, the class of
# the instructions that bound the kernel, their count an element).  M2 is
# held by its xors, which only the integer ALU issues (its adds may issue
# on the multiply pipe beside them).  M3's class and count come from its
# SASS (sass_bound): a group's 2 products and 13 adds, shifts and logic
# ops are whatever ptxas makes of them.
KERNELS = {
    "mul": (MC.mul, 2 * REPS, "imad", REPS),
    "add": (MC.add, 2 * REPS, "alu", REPS),
    "mix": (MC.mix, REPS * 10 // 4, None, None),
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return float(out.split()[0]) * 1e6


def device_from_args(prog: str, device: str) -> torch.device:
    """torch.device(device), after printing the card's line on the card;
    exits non-zero for cuda without a card."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog}: no CUDA device is available (--device=cpu runs the"
                             " plain versions)")
        print(card_line(), flush=True)
    return torch.device(device)


def u32_inputs(bits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tools' inputs: a in [0, 2^bits), b in [1, 2^bits), (ROWS,
    COLS x TILES) uint32 from default_rng(0)."""
    rng = np.random.default_rng(0)
    shape = (ROWS, COLS * TILES)
    a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint32)
    b = rng.integers(1, 1 << bits, size=shape, dtype=np.uint32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def time_ms(fn, device: torch.device) -> float:
    """ms of one fn() call: the device time on the card, one call on the
    host clock on the CPU."""
    if device.type == "cuda":
        return device_ms(fn, TIMED_CALLS)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def per_clock(count: float, ms: float) -> float:
    """count instructions in ms as a rate an SM a clock of the card at its
    maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return count / (ms * 1e-3) / (sms * max_sm_clock_hz())


def cuobjdump_sass(lib: str) -> str:
    """The SASS listing of a built library (cuobjdump -sass)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=600,
                          check=True).stdout


def pipe_counts(ops: list[str]) -> dict:
    """A SASS listing's integer instructions by the pipes that must issue
    them: "imad" only the multiply pipe, "alu" only the integer ALU, "int"
    all of them, the adds free to take either pipe (PEAK_PER_CLOCK)."""
    either = sum(o.startswith(EITHER_PIPE) for o in ops)
    imad = sum(o.startswith(("IMAD", "IMUL")) and not o.startswith(EITHER_PIPE) for o in ops)
    alu = sum(o.startswith(ALU_ONLY) for o in ops)
    return {"imad": imad, "alu": alu, "int": imad + alu + either}


def sass_bound(part: str) -> tuple[str, int, dict]:
    """The class and count of the instructions that bound the fully
    unrolled kernel whose mangled name holds `part`, in the built library:
    of its pipe_counts (a thread's, unrolled), the one that takes its pipes
    longest.  Returns the class, the count and all pipe_counts."""
    sass = cuobjdump_sass(os.path.join(build.build_dir(), build.LIB_NAME))
    chunk = next(c for c in sass.split("Function : ")[1:] if part in c.split("\n", 1)[0])
    pipes = pipe_counts([op for _, op, _ in SASS_OP.findall(chunk)])
    cls = max(pipes, key=lambda c: pipes[c] / PEAK_PER_CLOCK[c])
    return cls, pipes[cls], pipes


def run_elem(name: str, label: str, fn, tool_ops: int, cls: str | None, count: int | None,
             a, b, unit: str) -> dict:
    """Time fn(a, b) and print its line: the JAX tool's rate in `unit`
    (tool_ops an element) and, on the card, the rate an SM a clock of the
    `count` instructions of class `cls` an element (both None: M3's, from
    its SASS)."""
    ms = time_ms(lambda: fn(a, b), a.device)
    n = a.numel()
    res = {"name": name, "ms": ms, "device": a.device.type,
           "tool_rate": tool_ops * n / (ms * 1e-3) / 1e12}
    if a.device.type == "cuda":
        pipes = ""
        if cls is None:
            cls, count, res["pipes"] = sass_bound(MIX_KERNEL)
            pipes = f"; its SASS an element: {res['pipes']}"
        res.update({"class": cls, "count": count * n, "per_clock": per_clock(count * n, ms)})
        peak = PEAK_PER_CLOCK[cls]
        print(f"{label}: {ms:.6f} ms (device) -> {res['tool_rate']:.3f} {unit}; {cls}"
              f" {res['per_clock']:.2f} a clock an SM (peak {peak},"
              f" {100 * res['per_clock'] / peak:.1f} %){pipes}", flush=True)
    else:
        print(f"{label}: {ms:.1f} ms (cpu: the plain version, host clock) ->"
              f" {res['tool_rate']:.6f} {unit}", flush=True)
    return res


def check_names(ap: argparse.ArgumentParser, names: list[str], known) -> list[str]:
    bad = [n for n in names if n not in known]
    if bad:
        ap.error(f"unknown kernel {bad[0]!r} (choose from {', '.join(known)})")
    return names or list(known)


def main(argv: list[str] | None = None, results: list | None = None) -> int:
    """Run the named kernels; each one's measurements are appended to
    `results` when it is given."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"kernels to run, of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    names = check_names(ap, args.names, KERNELS)
    device = device_from_args("microbench", args.device)
    a, b = u32_inputs(16, device)
    for name in names:
        fn, tool_ops, cls, count = KERNELS[name]
        res = run_elem(name, name, fn, tool_ops, cls, count, a, b, "Tops/s (u32)")
        if results is not None:
            results.append(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
