"""Wrappers of the CUDA Poseidon2 kernels K1 (permutation / compression) and
K2 (rate-2 sponge), csrc/poseidon2_bn254.cu.

Port of codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py
(`permutation`, `compress`, `sponge2_absorb`), and `sponge2_rows`, the
whole cell-hash step from byte rows in one K2 launch.  A CUDA tensor
launches the kernel; a CPU tensor goes to the plain version
(ops/poseidon2_plain.py).  Each launch adds one to
kernels.build.LAUNCHES["perm"], ["sponge2"] (byte rows) or
["sponge2_planes"] (limb planes).  Planes are int32 16-bit limbs in
canonical Montgomery form (< P).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from . import poseidon2_plain as plain

NL = plain.NL


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_perm(x, y, z, key: int, out_lanes: int) -> torch.Tensor:
    """K1 on lanes x, y (16, n) views and z (16, n) view or key index."""
    n = x.shape[1]
    out = torch.empty((out_lanes, NL, n), dtype=torch.int32, device=x.device)
    dev, stream = build.launch_args(x)
    zs = (None, 0, 0) if z is None else (_ptr(z), z.stride(0), z.stride(1))
    err = build.load().cspc_p2_perm(
        _ptr(x), x.stride(0), x.stride(1),
        _ptr(y), y.stride(0), y.stride(1),
        *zs, key, _ptr(out), out_lanes, n, dev, stream,
    )
    build.check(err, "poseidon2 permutation kernel")
    build.LAUNCHES["perm"] += 1
    return out


def permutation(state: torch.Tensor) -> torch.Tensor:
    """(3, NL, B) Montgomery batch -> permuted (3, NL, B)."""
    if state.device.type == "cpu":
        return plain.permutation(state)
    build.require_cuda(state, "permutation", torch.int32, (3, NL, None))
    return _launch_perm(state[0], state[1], state[2], 0, 3)


def compress_layer(x: torch.Tensor, y: torch.Tensor, key: int) -> torch.Tensor:
    """Keyed 2-to-1 compression (NL, B) x (NL, B) -> (NL, B), key in 0..3.

    x and y may be strided views (a layer's even and odd columns); the
    kernel reads them in place.
    """
    if not 0 <= key < 4:
        raise ValueError(f"compress_layer: key {key} not in 0..3")
    if x.device.type == "cpu":
        return plain.compress(x, y, plain.KEY_MONT[key])
    for t in (x, y):
        build.require_cuda(t, "compress_layer", torch.int32, (NL, x.shape[1]))
    return _launch_perm(x, y, None, key, 1)[0]


def sponge2_absorb(blocks: torch.Tensor) -> torch.Tensor:
    """Rate-2 sponge over pre-padded (nb, 2, NL, B) Montgomery blocks ->
    the squeezed first lane (NL, B)."""
    if blocks.device.type == "cpu":
        return plain.sponge2_absorb(blocks)
    build.require_cuda(blocks, "sponge2_absorb", torch.int32, (None, 2, NL, None))
    if not blocks.is_contiguous():
        raise ValueError("sponge2_absorb: blocks must be contiguous")
    nb, _, _, n = blocks.shape
    out = torch.empty((NL, n), dtype=torch.int32, device=blocks.device)
    dev, stream = build.launch_args(blocks)
    err = build.load().cspc_p2_sponge2(_ptr(blocks), nb, _ptr(out), n, dev, stream)
    build.check(err, "poseidon2 sponge2 kernel")
    build.LAUNCHES["sponge2_planes"] += 1
    return out


def sponge2_rows(rows: torch.Tensor) -> torch.Tensor:
    """Cell hashes of (cell_size, B) uint8 byte rows -> (NL, B) Montgomery:
    byte encode, Montgomery form, felt padding and sponge in one launch.
    rows may be any strided view (the PRNG's rows, or a (B, cell_size).T
    view of cells); the kernel reads it in place."""
    if rows.device.type == "cpu":
        return plain.sponge2_rows(rows)
    build.require_cuda(rows, "sponge2_rows", torch.uint8, (None, None))
    cell_size, n = rows.shape
    out = torch.empty((NL, n), dtype=torch.int32, device=rows.device)
    dev, stream = build.launch_args(rows)
    err = build.load().cspc_p2_sponge2_rows(
        _ptr(rows), rows.stride(0), rows.stride(1), cell_size, _ptr(out), n, dev, stream
    )
    build.check(err, "poseidon2 sponge2 kernel (byte rows)")
    build.LAUNCHES["sponge2"] += 1
    return out
