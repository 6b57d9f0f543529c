"""State carried across from the JAX package.

The port runs no model, so its "weights" are the Poseidon2 constant tables
and the digest-layer stacks that a slot build produces.  Both cross as
numpy arrays of 16-bit limb planes (the JAX package's uint32 layout) and
become the port's int32 planes.
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
    """list of (16, W) uint32 limb-plane arrays -> int32 tensors on device."""
    out = []
    for lyr in layers:
        if np.ndim(lyr) != 2 or np.shape(lyr)[0] != 16:
            raise ValueError(f"layer shape {np.shape(lyr)} is not (16, W)")
        out.append(_planes(lyr, device))
    return out


def layers_to_numpy(layers) -> list[np.ndarray]:
    """list of (16, W) int32 tensors -> uint32 limb-plane arrays."""
    return [lyr.detach().cpu().numpy().astype(np.uint32) for lyr in layers]
