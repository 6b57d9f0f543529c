"""Wrappers of the CUDA Poseidon2 kernels K1 (permutation / compression) and
K2 (rate-2 sponge), csrc/poseidon2_bn254.cu.

Port of codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py
(`permutation`, `compress`, `sponge2_absorb`), and `sponge2_rows`, the
whole cell-hash step from byte rows in one K2 launch, and `tree_layers`,
the keyed compressions of many tree layers in one launch of the subtree
kernel (K1 on the main path), which writes them canonical.  A CUDA tensor
launches the kernel; a CPU tensor goes to the plain version
(ops/poseidon2_plain.py).  Each launch adds one to
kernels.build.LAUNCHES["p2_tree"] (subtree), ["perm"] (permutation and
compression), ["sponge2"] (byte rows) or ["sponge2_planes"] (limb planes).
Planes are int32 16-bit limbs in canonical Montgomery form (< P), but for
the canonical layers tree_layers returns.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from . import limbs as L
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


def tree_layers(layer: torch.Tensor, levels: int, key_bits: int, stop_width: int = 1,
                mont: bool = True) -> list[torch.Tensor]:
    """The `levels` keyed compression layers above a (NL, W) layer of
    `stop_width` power-of-two trees side by side (W = stop_width << levels),
    all canonical: [layer 0, layer 1, ..., layer `levels`], layer j + 1 (of
    width W >> (j + 1)) pairing the columns of layer j with key
    (key_bits >> j) & 1.  `layer` is in Montgomery form (mont, the cell
    hashes; layer 0 is then returned canonical) or canonical (not mont, the
    roots of subtrees; layer 0 is then `layer` itself).  On the card the
    subtree kernel makes them in one launch for W <= 2^8, else in launches
    of up to 11 levels (8 once the width is at most 2^15) until the width is
    at most 2^8, then one more (a 2^18-node chunk cut at 2^14 nodes: one
    launch; a 1 GB slot's 2^15-node joined frontier to its root: two; a
    2^18-node chunk to its root: two); the layers are contiguous views of
    one buffer."""
    w = layer.shape[1]
    if not 0 <= levels <= 31 or stop_width < 1 or w != stop_width << levels:
        raise ValueError(f"tree_layers: width {w} is not {stop_width} trees of 2^{levels}")
    if layer.device.type == "cpu":
        return plain.tree_layers(layer, levels, key_bits, mont)
    build.require_cuda(layer, "tree_layers", torch.int32, (NL, None))
    if levels == 0:  # no compression: one node a tree
        return [L.from_mont(layer) if mont else layer]
    size = w - stop_width + (w if mont else 0)
    out = torch.empty(NL * size, dtype=torch.int32, device=layer.device)
    dev, stream = build.launch_args(layer)
    layers, off = [], 0
    if mont:
        layers.append(out[: NL * w].view(NL, w))
        off = NL * w
    else:
        layers.append(layer)
    cur, done = layer, ctypes.c_int(0)
    while len(layers) <= levels:
        first = cur is layer
        made = len(layers) - 1
        err = build.load().cspc_p2_tree(
            _ptr(cur), cur.stride(0), cur.stride(1), int(first and mont),
            _ptr(layers[0]) if first and mont else None,
            ctypes.c_void_p(out.data_ptr() + 4 * off), cur.shape[1], levels - made,
            (key_bits >> made) & 0xFFFFFFFF, ctypes.byref(done), dev, stream,
        )
        build.check(err, "poseidon2 subtree kernel")
        build.LAUNCHES["p2_tree"] += 1
        for _ in range(done.value):
            gw = cur.shape[1] // 2
            cur = out[off : off + NL * gw].view(NL, gw)
            layers.append(cur)
            off += NL * gw
    return layers


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
