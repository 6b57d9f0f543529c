"""The TPU microbenchmarks' kernel bodies in plain torch: the plain versions
of the six kernels of csrc/microbench.cu (ops/microbench_cuda.py).

Port of the kernel bodies of tools/microbench.py (`_mul_kernel`,
`_add_kernel`, `_mix_kernel`) and tools/microbench2.py (`_ilp_kernel`,
`_conv_kernel`, `_dot_kernel_factory`), with the tools' layouts: M1-M5
take two (ROWS, C) uint32 tensors a, b and return (ROWS, C) uint32; `dot`
takes A (K, C) and W (M, K) bfloat16 and returns (M, C) float32.  Every
column is independent, so the TPU's grid of (ROWS, COLS) tiles is no part
of the function.

u32 arithmetic runs in int64 masked to 32 bits (torch's uint32 has no `+`
or `>>` on the CPU); a product is split at 16 bits of its second factor so
that no int64 intermediate exceeds 2^49.
"""

from __future__ import annotations

import torch

ROWS = 16  # tools/microbench.py:21, tools/microbench2.py:25
COLS = 512  # the TPU tile's width
TILES = 64  # the tools' grid: (ROWS, COLS * TILES) elements
REPS = 512  # chained op groups of M1-M3 (tools/microbench.py:23)
REPS2 = 256  # multiplies of M4, half of them round trips of M5 (tools/microbench2.py:27)
MASK = 0xFFFFFFFF


def _u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint32)


def _mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 for int64 tensors holding u32 values."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & MASK


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M1: REPS groups of a = a * b; b = b + a; out a + b."""
    a, b = _u64(a), _u64(b)
    for _ in range(REPS):
        a = _mul(a, b)
        b = (b + a) & MASK
    return _u32((a + b) & MASK)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M2: REPS groups of a = a + b; b = b ^ a; out a + b."""
    a, b = _u64(a), _u64(b)
    for _ in range(REPS):
        a = (a + b) & MASK
        b = b ^ a
    return _u32((a + b) & MASK)


def mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M3: REPS / 4 groups of a Montgomery step's mix (2 multiplies, 13
    adds, shifts and logic ops); out a + b."""
    a, b = _u64(a), _u64(b)
    for _ in range(REPS // 4):
        t = _mul(a, b)
        q = _mul(b, a)
        a = (t & 0xFFFF) + (q >> 16)
        b = ((b + (t >> 16)) & MASK) ^ (q & 0xFFFF)
        a = (a + b) & MASK
        b = (b + t) & MASK
        a = a ^ q
        b = (b + a) & MASK
        a = (a + q) & MASK
        b = b ^ t
    return _u32((a + b) & MASK)


def ilp(a: torch.Tensor, b: torch.Tensor, nstreams: int) -> torch.Tensor:
    """M4: nstreams independent chains x_i = a + i, each multiplied by b
    REPS2 / nstreams times; out the sum of the chains."""
    if nstreams < 1 or REPS2 % nstreams:
        raise ValueError(f"ilp: {nstreams} streams do not divide {REPS2} multiplies")
    a, b = _u64(a), _u64(b)
    xs = [(a + i) & MASK for i in range(nstreams)]
    for _ in range(REPS2 // nstreams):
        xs = [_mul(x, b) for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = (acc + x) & MASK
    return _u32(acc)


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M5: REPS2 / 2 round trips u32 -> i32 -> f32 -> i32 -> u32 of a & 0xFF,
    summed (b is not read, as in the TPU kernel)."""
    del b
    a = _u64(a)
    acc = torch.zeros_like(a)
    for _ in range(REPS2 // 2):
        f = (a & 0xFF).to(torch.int32).to(torch.float32)
        acc = (acc + f.to(torch.int32).to(torch.int64)) & MASK
    return _u32(acc)


def dot(a: torch.Tensor, w: torch.Tensor, n_dots: int) -> torch.Tensor:
    """M6: acc = sum over n_dots products W @ A in float32, A (K, C) and W
    (M, K) bfloat16, with A = bf16(A + 1) after each product (round to
    nearest even: 257 rounds to 256).  Each product is taken in float64,
    where the products of bf16 values and their sums of K terms are exact
    for the tools' integer inputs, and rounded to float32 once; the n_dots
    products are summed in float32."""
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"dot: expected bfloat16 A and W, got {a.dtype} and {w.dtype}")
    if a.ndim != 2 or w.ndim != 2 or w.shape[1] != a.shape[0]:
        raise ValueError(f"dot: W {tuple(w.shape)} and A {tuple(a.shape)} do not chain")
    w64 = w.to(torch.float64)
    acc = torch.zeros((w.shape[0], a.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(n_dots):
        acc += (w64 @ a.to(torch.float64)).to(torch.float32)
        a = (a.to(torch.float32) + 1.0).to(torch.bfloat16)
    return acc
