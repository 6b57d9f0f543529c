"""Batched Poseidon2 t=3 permutation / compression / sponge, in plain torch.

Port of codex_storage_proofs_circuits_tpu/ops/poseidon2_jnp.py and the plain
version of the CUDA kernels K1 (permutation) and K2 (rate-2 sponge, and
the cell hash from byte rows) in ops/poseidon2_cuda.py.  A batch of states
is (3, NL, B): 3 lanes x 16 limb planes x batch, all in Montgomery form.

Round schedule of the reference circuit (poseidon2_perm.circom:163-198):
initial linear layer, 4 external rounds, 56 internal rounds, 4 external
rounds; x^5 S-box.  Python loops take the place of lax.scan.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bn254
from . import convert
from . import encode as E
from . import limbs as L

NL = L.NL


def _mont_limbs(x: int) -> np.ndarray:
    return np.array(L.int_limbs(bn254.to_mont(x)), dtype=np.uint32).reshape(NL, 1)


_TABLES = convert.tables_from_numpy(
    np.stack(
        [np.stack([_mont_limbs(c) for c in t]) for t in bn254.EXTERNAL_ROUND_CONSTS]
    ),
    np.stack([_mont_limbs(c) for c in bn254.INTERNAL_ROUND_CONSTS]),
    np.stack([_mont_limbs(k) for k in range(4)]),
    _mont_limbs((1 << 64) + 0x0302),
    _mont_limbs(1),
)
EXT_RC_MONT = _TABLES["ext_rc"]  # (8, 3, NL, 1) int32
INT_RC_MONT = _TABLES["int_rc"]  # (56, NL, 1)
KEY_MONT = _TABLES["keys"]  # (4, NL, 1): Merkle keys 0..3
SPONGE2_IV_MONT = _TABLES["iv2"]  # (NL, 1)
ONE_MONT = _TABLES["one"]  # (NL, 1)


@functools.lru_cache(maxsize=None)
def _rc(device: torch.device):
    """Round constants as int64 on `device`, limb axis first: external
    (8, NL, 3, 1) and internal (56, NL, 1)."""
    ext = EXT_RC_MONT.to(device, torch.int64).permute(0, 2, 1, 3).contiguous()
    return ext, INT_RC_MONT.to(device, torch.int64)


def _sbox(x):
    x2 = L.mont_mul(x, x)
    x4 = L.mont_mul(x2, x2)
    return L.mont_mul(x4, x)


def _mix(st):
    """st -> st + (x + y + z) on every lane; st is (NL, 3, B)."""
    s = L.add_mod(L.add_mod(st[:, 0], st[:, 1]), st[:, 2])
    return L.add_mod(st, s.unsqueeze(1))


def _external_round(st, rc):
    return _mix(_sbox(L.add_mod(st, rc)))


def _internal_round(st, c):
    # out = [[2,1,1],[1,2,1],[1,1,3]] @ (sbox(x+c), y, z)
    x, y, z = st.unbind(1)
    xz = L.add_mod(torch.stack([x, z], 1), torch.stack([c.expand_as(x), z], 1))
    sx = _sbox(xz[:, 0])
    u = L.add_mod(L.add_mod(sx, y), z)
    return L.add_mod(u.unsqueeze(1), torch.stack([sx, y, xz[:, 1]], 1))


def _permute(st):
    """The 64-round permutation on an int64 (NL, 3, B) state: the lanes
    batch into one tensor so that each field op runs once for all three.
    The rounds run under inference mode, which spares each of their
    thousands of small ops the autograd dispatch; the result is cloned out
    of it, so that callers may update it in place."""
    ext, inner = _rc(st.device)
    with torch.inference_mode():
        st = _mix(st)
        for r in range(4):
            st = _external_round(st, ext[r])
        for r in range(inner.shape[0]):
            st = _internal_round(st, inner[r])
        for r in range(4, 8):
            st = _external_round(st, ext[r])
    return st.clone()


def permutation(state: torch.Tensor) -> torch.Tensor:
    """Full 64-round permutation on a (3, NL, B) Montgomery-form batch."""
    st = _permute(state.to(torch.int64).transpose(0, 1))
    return st.transpose(0, 1).to(state.dtype)


def compress(x: torch.Tensor, y: torch.Tensor, key_mont: torch.Tensor) -> torch.Tensor:
    """Batched keyed 2-to-1 compression: first lane of permutation(x, y, key).

    x, y: (NL, B); key_mont: (NL, 1) or (NL, B) Montgomery-form key.
    """
    key = key_mont.to(x.device, x.dtype).expand(NL, x.shape[1])
    st = torch.stack([x, y, key], 1).to(torch.int64)
    return _permute(st)[:, 0].to(x.dtype)


def tree_layers(layer: torch.Tensor, levels: int, key_bits: int,
                mont: bool = True) -> list[torch.Tensor]:
    """The plain version of the subtree kernel (ops/poseidon2_cuda.py
    tree_layers, where the arguments are described): one compression a
    layer, layer j + 1 with key (key_bits >> j) & 1, then every layer out
    of Montgomery form in one multiply (`layer` itself stays when it came
    in canonical)."""
    cur = layer if mont else L.to_mont(layer)
    layers = [cur]
    for j in range(levels):
        cur = compress(cur[:, 0::2], cur[:, 1::2], KEY_MONT[(key_bits >> j) & 1])
        layers.append(cur)
    canon = L.from_mont(torch.cat(layers, dim=1))
    out = list(torch.split(canon, [lyr.shape[1] for lyr in layers], dim=1))
    if not mont:
        out[0] = layer
    return out


def sponge2_absorb(blocks: torch.Tensor) -> torch.Tensor:
    """Rate-2 sponge over pre-padded blocks.

    blocks: (nblocks, 2, NL, B) Montgomery-form field elements, already
    including the felt-level `10*` padding.  Returns the squeezed first lane
    (NL, B) in Montgomery form.
    """
    nb, two, nl, b = blocks.shape
    if two != 2 or nl != NL:
        raise ValueError(f"sponge2_absorb: blocks shape {tuple(blocks.shape)}")
    st = blocks.new_zeros((NL, 3, b), dtype=torch.int64)
    st[:, 2] = SPONGE2_IV_MONT.to(blocks.device)
    for k in range(nb):
        xy = L.add_mod(st[:, :2], blocks[k].to(torch.int64).transpose(0, 1))
        st = _permute(torch.cat([xy, st[:, 2:]], 1))
    return st[:, 0].to(blocks.dtype)


def pad_felts_rate2(felts: torch.Tensor) -> torch.Tensor:
    """(nfelts, NL, B) Montgomery felts -> (nblocks, 2, NL, B) padded blocks.

    Appends the Montgomery form of 1 (and a 0 filler when needed) per the
    felt-level `10*` padding (poseidon2_sponge.circom:43-50).
    """
    nfelts, nl, b = felts.shape
    n_pad = 1 + (nfelts + 1) % 2
    padded = felts.new_zeros((nfelts + n_pad, nl, b))
    padded[:nfelts] = felts
    padded[nfelts] = ONE_MONT.to(felts.device, felts.dtype)
    return padded.reshape(-1, 2, nl, b)


def sponge2_hash(felts: torch.Tensor) -> torch.Tensor:
    """Batched sponge2 of (nfelts, NL, B) Montgomery felts -> (NL, B)."""
    return sponge2_absorb(pad_felts_rate2(felts))


def to_mont_stack(felts: torch.Tensor) -> torch.Tensor:
    """(K, NL, B) canonical -> Montgomery, as one batched (NL, K, B) multiply."""
    return L.to_mont(felts.transpose(0, 1)).transpose(0, 1).contiguous()


def sponge2_rows(rows: torch.Tensor) -> torch.Tensor:
    """Cell hashes of (cell_size, B) byte rows (byte i of every cell in row
    i; any integer dtype and strides) -> (NL, B) Montgomery: the byte encode
    with `10*` padding, the Montgomery form, the felt padding and the rate-2
    sponge, as JAX models/hashing.py::hash_cells_mont on the encoded cells."""
    return sponge2_absorb(pad_felts_rate2(to_mont_stack(E.encode_rows(rows))))
