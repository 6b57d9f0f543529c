"""State carried across from the JAX package.

The port runs no model, so its "weights" are the hash constant tables and
the digest-layer stacks that a slot build produces: BN254 Poseidon2 tables
and (16, W) layers, Goldilocks tables and (4, 4, W) digest layers.  Both
cross as numpy arrays of 16-bit limb planes (the JAX package's uint32
layout) and become the port's int32 planes.
"""

from __future__ import annotations

import numpy as np
import torch


def _planes(arr: np.ndarray, device=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limb planes must hold 16-bit values")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def tables_from_numpy(ext_rc, int_rc, keys, iv2, one) -> dict[str, torch.Tensor]:
    """The Poseidon2 tables in Montgomery limb planes -> int32 tensors.

    Shapes as in ops/poseidon2_jnp.py: ext_rc (8, 3, 16, 1), int_rc
    (56, 16, 1), keys (4, 16, 1), iv2 (16, 1), one (16, 1).
    """
    tables = {
        "ext_rc": _planes(ext_rc),
        "int_rc": _planes(int_rc),
        "keys": _planes(keys),
        "iv2": _planes(iv2),
        "one": _planes(one),
    }
    want = {
        "ext_rc": (8, 3, 16, 1),
        "int_rc": (56, 16, 1),
        "keys": (4, 16, 1),
        "iv2": (16, 1),
        "one": (16, 1),
    }
    for name, shape in want.items():
        if tuple(tables[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(tables[name].shape)} != {shape}")
    return tables


def layers_from_numpy(layers, device=None) -> list[torch.Tensor]:
    """list of (16, W) BN254 or (4, 4, W) Goldilocks uint32 limb-plane
    arrays -> int32 tensors on device."""
    out = []
    for lyr in layers:
        if np.shape(lyr)[:-1] not in ((16,), (4, 4)):
            raise ValueError(f"layer shape {np.shape(lyr)} is not (16, W) or (4, 4, W)")
        out.append(_planes(lyr, device))
    return out


def layers_to_numpy(layers) -> list[np.ndarray]:
    """list of (16, W) or (4, 4, W) int32 tensors -> uint32 limb-plane arrays."""
    return [lyr.detach().cpu().numpy().astype(np.uint32) for lyr in layers]


def gl_tables_from_numpy(rc_table) -> dict[str, torch.Tensor]:
    """The JAX Goldilocks kernel's (48, 128) constant table
    (ops/goldilocks_pallas.py RC_TABLE: row = limb * 12 + lane; columns
    0..7 external round constants, 8 the internal diagonal mu - 1, 16..37
    internal round constants, 40 the sponge IV, 44..47 the Merkle keys,
    48..53 the Monolith round constants; single values in lane 0) -> the
    port's tables, laid out as ops/goldilocks_plain.py TABLES."""
    t = _planes(rc_table)
    if tuple(t.shape) != (48, 128):
        raise ValueError(f"rc_table: shape {tuple(t.shape)} != (48, 128)")
    t = t.reshape(4, 12, 128).permute(2, 1, 0)  # (column, lane, limb)
    return {
        "ext_rc": t[0:8].contiguous(),
        "int_rc": t[16:38, 0].contiguous(),
        "diag": t[8].contiguous(),
        "iv": t[40, 0].contiguous(),
        "keys": t[44:48, 0].contiguous(),
        "mono_rc": t[48:54].contiguous(),
    }
