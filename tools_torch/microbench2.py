"""Rates of independent u32 multiply chains, int-float conversions and
skinny bf16 tensor-core products on the card.

The twin of tools/microbench2.py: its kernels M4 (ilp4, ilp8: 4 or 8
independent chains x_i = (a + i) * b * b ..., 256 products an element),
M5 (conv: 128 round trips u32 -> i32 -> f32 -> i32 -> u32 of a & 0xFF)
and M6 (dot64x32: 64 products W (64, 32) @ A (32, 512 x 64); dot128x128:
16 products W (128, 128) @ A (128, 512 x 64); f32 sums from bf16, A =
bf16(A + 1) after each product), as the hand-written kernels of
csrc/microbench.cu (ops/microbench_cuda.py).  The inputs are the JAX
tool's, from numpy's default_rng(0): for M4 and M5 a in [0, 2^12) and b in
[1, 2^12), (16, 512 x 64) uint32; for M6 A and W integers in [0, 256).

    python3 -m tools_torch.microbench2 [ilp4|ilp8|conv|dot64x32|dot128x128 ...]
        [--device=cuda|cpu]

from the root of the checkout (default: all five; an unknown name exits
non-zero).  On the card it prints the card's name and power limit first,
then one line a kernel: its device time (kernels/timing.device_ms), the
JAX tool's T elem-ops/s or T MAC/s and M dots/s (a dot is one product on
a 512-column tile), and the rate beside its peak: for M4 and M5 the
products or conversions an SM a clock at the card's maximum SM clock, for
M6 TFLOP/s and MACs an SM a clock beside the bf16 tensor cores' 2048 a
clock.  --device=cpu runs the plain versions once each, timed on the host
clock; without a card --device=cuda fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
from codex_storage_proofs_circuits_tpu_torch.ops.microbench_plain import COLS, REPS2, TILES
from tools_torch.microbench import (
    TC_MACS_PER_CLOCK,
    check_names,
    device_from_args,
    per_clock,
    run_elem,
    time_ms,
    u32_inputs,
)

# name: (label of the JAX tool, kernel, the JAX tool's elem-ops an element,
# the class of the instructions that bound the kernel, their count an
# element): M4's products, M5's float -> int conversions (one a round trip;
# the other conversion, I2FP, does not issue on the conversion pipe)
ELEM = {
    "ilp4": ("ilp4 u32 mul", lambda a, b: MC.ilp(a, b, 4), REPS2, "imad", REPS2),
    "ilp8": ("ilp8 u32 mul", lambda a, b: MC.ilp(a, b, 8), REPS2, "imad", REPS2),
    "conv": ("u32<->f32 conv", MC.conv, REPS2, "cvt", REPS2 // 2),
}
DOTS = {"dot64x32": (64, 32, 64), "dot128x128": (128, 128, 16)}  # M, K, n_dots
KERNELS = (*ELEM, *DOTS)


def dot_inputs(m: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's A (k, COLS x TILES) and W (m, k): integers in [0,
    256) as bf16, A first, from default_rng(0)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, size=(k, COLS * TILES)).astype(np.float32)
    w = rng.integers(0, 256, size=(m, k)).astype(np.float32)
    return (torch.from_numpy(a).to(torch.bfloat16).to(device),
            torch.from_numpy(w).to(torch.bfloat16).to(device))


def run_dot(name: str, device: torch.device) -> dict:
    m, k, n_dots = DOTS[name]
    a, w = dot_inputs(m, k, device)
    ms = time_ms(lambda: MC.dot(a, w, n_dots), device)
    dots = TILES * n_dots
    macs = dots * m * k * COLS
    s = ms * 1e-3
    res = {"name": name, "ms": ms, "device": device.type, "class": "tc", "count": 2 * macs,
           "tool_rate": macs / s / 1e12, "tflops": 2 * macs / s / 1e12}
    where = "device" if device.type == "cuda" else "cpu: the plain version, host clock"
    line = (f"dot ({m},{k}): {ms:.6f} ms ({where}) -> {res['tool_rate']:.3f} T MAC/s"
            f" ({dots / s / 1e6:.2f} M dots/s of ({m},{k})x({k},{COLS}))")
    if device.type == "cuda":
        res["per_clock"] = per_clock(macs, ms)
        share = res["per_clock"] / TC_MACS_PER_CLOCK
        line += (f"; {res['tflops']:.2f} TFLOP/s, {res['per_clock']:.1f} MAC a clock an SM"
                 f" ({100 * share:.1f} % of the bf16 tensor cores' {TC_MACS_PER_CLOCK},"
                 f" {res['tflops'] / share:.2f} TFLOP/s at the maximum SM clock)")
    print(line, flush=True)
    return res


def main(argv: list[str] | None = None, results: list | None = None) -> int:
    """Run the named kernels; each one's measurements are appended to
    `results` when it is given."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"kernels to run, of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    names = check_names(ap, args.names, KERNELS)
    device = device_from_args("microbench2", args.device)
    for name in names:
        if name in ELEM:
            label, fn, tool_ops, cls, count = ELEM[name]
            a, b = u32_inputs(12, device)
            res = run_elem(name, label, fn, tool_ops, cls, count, a, b, "T elem-ops/s")
        else:
            res = run_dot(name, device)
        if results is not None:
            results.append(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
