"""Wrappers of the CUDA microbenchmark kernels M1-M6, csrc/microbench.cu.

Port of the Pallas kernels of tools/microbench.py (M1 `_mul_kernel`, M2
`_add_kernel`, M3 `_mix_kernel`) and tools/microbench2.py (M4
`_ilp_kernel`, M5 `_conv_kernel`, M6 `_dot_kernel_factory`), with the
layouts of their plain versions (ops/microbench_plain.py): M1-M5 take two
(ROWS, C) uint32 tensors and return (ROWS, C) uint32; `dot` takes A (K, C)
and W (M, K) bfloat16 and returns (M, C) float32.  A CUDA tensor launches
the kernel; a CPU tensor goes to the plain version.  Each launch adds one
to kernels.build.LAUNCHES["mb_mul"], ["mb_add"], ["mb_mix"], ["mb_ilp"],
["mb_conv"] or ["mb_dot"].
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from . import microbench_plain as plain

ILP_STREAMS = (4, 8)  # the stream counts the kernel is built for (the tool's ilp4, ilp8)
DOT_SHAPES = ((64, 32), (128, 128))  # (M, K) the kernel is built for (dot64x32, dot128x128)
DOT_COLS = 64  # the columns a CTA of M6 owns (wgmma's 64 rows): C must be a multiple
# M6's relative tolerance against its plain version (and between two builds
# of it): n_dots x K = 2048 float32 roundings of at most 2^-24 each
# (1.2e-4), times 2 for the order of the sums
DOT_RTOL = 2.5e-4
_OPS = {"mul": 0, "add": 1, "mix": 2, "ilp4": 3, "ilp8": 4, "conv": 5}  # cspc_mb_elem's op


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _elem(op: str, counter: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    build.require_cuda(a, f"microbench {counter}", torch.uint32, (plain.ROWS, None))
    build.require_cuda(b, f"microbench {counter}", torch.uint32, tuple(a.shape))
    for t in (a, b):
        if not t.is_contiguous():
            raise ValueError(f"microbench {counter}: inputs must be contiguous")
    out = torch.empty_like(a)
    dev, stream = build.launch_args(a)
    err = build.load().cspc_mb_elem(_OPS[op], _ptr(a), _ptr(b), _ptr(out), a.numel(), dev,
                                    stream)
    build.check(err, f"microbench kernel {counter}")
    build.LAUNCHES[counter] += 1
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M1: 512 groups of a = a * b; b = b + a; out a + b."""
    if a.device.type == "cpu":
        return plain.mul(a, b)
    return _elem("mul", "mb_mul", a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M2: 512 groups of a = a + b; b = b ^ a; out a + b."""
    if a.device.type == "cpu":
        return plain.add(a, b)
    return _elem("add", "mb_add", a, b)


def mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M3: 128 groups of a Montgomery step's mix; out a + b."""
    if a.device.type == "cpu":
        return plain.mix(a, b)
    return _elem("mix", "mb_mix", a, b)


def ilp(a: torch.Tensor, b: torch.Tensor, nstreams: int) -> torch.Tensor:
    """M4: nstreams independent product chains of (a + i) by b, 256
    products in all, summed.  The kernel takes 4 or 8 streams."""
    if a.device.type == "cpu":
        return plain.ilp(a, b, nstreams)
    if nstreams not in ILP_STREAMS:
        raise ValueError(f"ilp: the kernel is built for {ILP_STREAMS} streams, not {nstreams}")
    return _elem(f"ilp{nstreams}", "mb_ilp", a, b)


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M5: 128 round trips u32 -> i32 -> f32 -> i32 -> u32 of a & 0xFF,
    summed."""
    if a.device.type == "cpu":
        return plain.conv(a, b)
    return _elem("conv", "mb_conv", a, b)


def dot(a: torch.Tensor, w: torch.Tensor, n_dots: int) -> torch.Tensor:
    """M6: the sum of n_dots products W (M, K) @ A (K, C) in float32 from
    bfloat16, A = bf16(A + 1) after each.  The kernel takes (M, K) of
    DOT_SHAPES, C a multiple of DOT_COLS, and A and W at 16-byte aligned
    addresses (it copies them 16 bytes a thread)."""
    if a.device.type == "cpu":
        return plain.dot(a, w, n_dots)
    m, k = w.shape if w.ndim == 2 else (None, None)
    if (m, k) not in DOT_SHAPES:
        raise ValueError(f"dot: W {tuple(w.shape)}: the kernel is built for (M, K) in {DOT_SHAPES}")
    build.require_cuda(w, "dot", torch.bfloat16, (m, k))
    build.require_cuda(a, "dot", torch.bfloat16, (k, None))
    cols = a.shape[1]
    if cols % DOT_COLS or cols == 0:
        raise ValueError(f"dot: {cols} columns are not a positive multiple of {DOT_COLS}")
    if n_dots < 0:
        raise ValueError(f"dot: {n_dots} products")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("dot: A and W must be contiguous")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("dot: A and W must start at 16-byte aligned addresses")
    out = torch.empty((m, cols), dtype=torch.float32, device=a.device)
    dev, stream = build.launch_args(a)
    err = build.load().cspc_mb_dot(m, k, _ptr(a), _ptr(w), _ptr(out), n_dots, cols, dev, stream)
    build.check(err, "microbench kernel mb_dot")
    build.LAUNCHES["mb_dot"] += 1
    return out
