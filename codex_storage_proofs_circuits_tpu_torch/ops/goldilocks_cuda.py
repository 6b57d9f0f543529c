"""Wrappers of the CUDA Goldilocks kernels K4 (Poseidon2-GL permutation /
compression), K5 (Monolith) and K6 (rate-8 sponge), csrc/goldilocks.cu.

Port of codex_storage_proofs_circuits_tpu/ops/goldilocks_pallas.py
(`permutation`, `compress`, `sponge_digest_felts`), and
`sponge_digest_rows`, the whole cell-digest step from byte rows in one K6
launch, and `tree_layers`, the keyed compressions of many tree layers in
one launch of the subtree kernel (K4 / K5 on the main path).  A CUDA
tensor launches the kernel; a CPU tensor goes to the plain version
(ops/goldilocks_plain.py).
Each launch adds one to kernels.build.LAUNCHES: "gl_perm" (K4) or
"mono_perm" (K5), for the permutation and compression entries and for
each subtree launch, and "gl_sponge8" or "mono_sponge8" (K6 with each
core, byte rows; its limb-plane entry counts under "gl_sponge8_planes" or
"mono_sponge8_planes").
Planes are int32 16-bit limbs; outputs are canonical.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from . import goldilocks_plain as plain

NL = plain.NL
T = plain.T
_HASH_ID = {"poseidon2": 0, "monolith": 1}
_PERM_COUNTER = {"poseidon2": "gl_perm", "monolith": "mono_perm"}
_SPONGE_COUNTER = {"poseidon2": "gl_sponge8", "monolith": "mono_sponge8"}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _hash_id(hash_fun: str) -> int:
    if hash_fun not in _HASH_ID:
        raise ValueError(f"unknown hash {hash_fun!r}: expected one of {tuple(_HASH_ID)}")
    return _HASH_ID[hash_fun]


def _launch_perm(hash_fun: str, x, y, key: int, out_lanes: int) -> torch.Tensor:
    """K4/K5 on the (12, 4, n) view x, or on the (4, 4, n) views x, y with
    the Merkle key `key`."""
    n = x.shape[2]
    out = torch.empty((out_lanes, NL, n), dtype=torch.int32, device=x.device)
    dev, stream = build.launch_args(x)
    ys = (None, 0, 0, 0) if y is None else (_ptr(y), *y.stride())
    err = build.load().cspc_gl_perm(
        _hash_id(hash_fun), _ptr(x), *x.stride(), *ys, key, _ptr(out), out_lanes, n,
        dev, stream,
    )
    build.check(err, f"goldilocks {hash_fun} permutation kernel")
    build.LAUNCHES[_PERM_COUNTER[hash_fun]] += 1
    return out


def permutation(state: torch.Tensor, hash_fun: str = "poseidon2") -> torch.Tensor:
    """(12, 4, B) states (values below 2^64) -> permuted canonical states."""
    if state.device.type == "cpu":
        return plain.permutation(state, hash_fun)
    build.require_cuda(state, "permutation", torch.int32, (T, NL, None))
    return _launch_perm(hash_fun, state, None, 0, T)


def compress(x: torch.Tensor, y: torch.Tensor, key: int,
             hash_fun: str = "poseidon2") -> torch.Tensor:
    """Keyed 2-digest compression (4, 4, W) x (4, 4, W) -> (4, 4, W), key in
    0..3.  x and y may be strided views (a layer's even and odd columns);
    the kernel reads them in place."""
    if not 0 <= key < 4:
        raise ValueError(f"compress: key {key} not in 0..3")
    if x.device.type == "cpu":
        return plain.compress_batch(hash_fun, key, x, y)
    for t in (x, y):
        build.require_cuda(t, "compress", torch.int32, (4, NL, x.shape[2]))
    return _launch_perm(hash_fun, x, y, key, 4)


def tree_layers(layer: torch.Tensor, hash_fun: str, levels: int, key_bits: int,
                stop_width: int = 1) -> list[torch.Tensor]:
    """The `levels` keyed compression layers above a (4, 4, W) digest layer
    of `stop_width` power-of-two trees side by side (W = stop_width <<
    levels): layer j + 1 (of width W >> (j + 1)) pairs the columns of layer j
    with key (key_bits >> j) & 1.  On the card the subtree kernel makes them
    all in one launch for W <= 2^11, else in one launch for each 11 levels
    until the width is at most 2^11, then one more (a 2^18-digest chunk:
    two); each is a contiguous (4, 4, W >> (j + 1)) view of one buffer."""
    w = layer.shape[2]
    if not 0 <= levels <= 31 or stop_width < 1 or w != stop_width << levels:
        raise ValueError(f"tree_layers: width {w} is not {stop_width} trees of 2^{levels}")
    if layer.device.type == "cpu":
        return plain.tree_layers(hash_fun, layer, levels, key_bits)
    build.require_cuda(layer, "tree_layers", torch.int32, (4, NL, None))
    hid = _hash_id(hash_fun)
    out = torch.empty(4 * NL * (w - stop_width), dtype=torch.int32, device=layer.device)
    dev, stream = build.launch_args(layer)
    layers, cur, off = [], layer, 0
    done = ctypes.c_int(0)
    while len(layers) < levels:
        err = build.load().cspc_gl_tree(
            hid, _ptr(cur), *cur.stride(), ctypes.c_void_p(out.data_ptr() + 4 * off),
            cur.shape[2], levels - len(layers), (key_bits >> len(layers)) & 0xFFFFFFFF,
            ctypes.byref(done), dev, stream,
        )
        build.check(err, f"goldilocks {hash_fun} subtree kernel")
        build.LAUNCHES[_PERM_COUNTER[hash_fun]] += 1
        for _ in range(done.value):
            gw = cur.shape[2] // 2
            cur = out[off : off + 4 * NL * gw].view(4, NL, gw)
            layers.append(cur)
            off += 4 * NL * gw
    return layers


def sponge_digest_felts(felts: torch.Tensor, hash_fun: str = "poseidon2") -> torch.Tensor:
    """Rate-8 sponge over (n, 4, B) felts (the kernel applies the `10*`
    felt padding) -> (4, 4, B) digests."""
    if felts.device.type == "cpu":
        return plain.sponge_digest_felts(hash_fun, felts)
    build.require_cuda(felts, "sponge_digest_felts", torch.int32, (None, NL, None))
    nf, _, n = felts.shape
    out = torch.empty((4, NL, n), dtype=torch.int32, device=felts.device)
    dev, stream = build.launch_args(felts)
    err = build.load().cspc_gl_sponge8(
        _hash_id(hash_fun), _ptr(felts), *felts.stride(), nf, _ptr(out), n, dev, stream
    )
    build.check(err, f"goldilocks {hash_fun} sponge kernel")
    build.LAUNCHES[_SPONGE_COUNTER[hash_fun] + "_planes"] += 1
    return out


def sponge_digest_rows(rows: torch.Tensor, hash_fun: str = "poseidon2") -> torch.Tensor:
    """Cell digests of (cell_size, B) uint8 byte rows -> (4, 4, B): byte
    encode and rate-8 sponge in one launch.  rows may be any strided view
    (the PRNG's rows, or a (B, cell_size).T view of cells); the kernel reads
    it in place."""
    if rows.device.type == "cpu":
        return plain.sponge_digest_rows(hash_fun, rows)
    build.require_cuda(rows, "sponge_digest_rows", torch.uint8, (None, None))
    cell_size, n = rows.shape
    out = torch.empty((4, NL, n), dtype=torch.int32, device=rows.device)
    dev, stream = build.launch_args(rows)
    err = build.load().cspc_gl_sponge8_rows(
        _hash_id(hash_fun), _ptr(rows), rows.stride(0), rows.stride(1), cell_size, _ptr(out), n,
        dev, stream,
    )
    build.check(err, f"goldilocks {hash_fun} sponge kernel (byte rows)")
    build.LAUNCHES[_SPONGE_COUNTER[hash_fun]] += 1
    return out
