"""Batched Goldilocks arithmetic, Poseidon2-GL and Monolith permutations,
keyed digest compression and rate-8 sponge, in plain torch.

Port of codex_storage_proofs_circuits_tpu/ops/gl_core.py and
ops/goldilocks_jnp.py, and the plain version of the CUDA kernels K4
(Poseidon2-GL), K5 (Monolith) and K6 (rate-8 sponge, and the cell digest
from byte rows) in ops/goldilocks_cuda.py, and of the subtree kernel
(`tree_layers`, many tree layers a launch).

Public layouts are the JAX package's: a felt batch is (4, B), a state
(12, 4, B), a digest batch (4, 4, B) and a felt sequence (n, 4, B), each a
plane of little-endian 16-bit limbs held as int32, canonical (< p).

Inside, the limbs are int64 with the limb axis first: a state is (4, 12, B).
On the CPU torch has no uint64 arithmetic, and a Goldilocks value reaches
2^64, which int64 cannot hold unsigned.  Between operations a value is
"loose": limbs below 2^16, value below 2^64 but not necessarily below p.
Limb columns are signed int64, so a carry or a borrow ripples with one
arithmetic shift per limb, and a carry out of the top limb folds back with
2^64 = 2^32 - 1 (mod p).  A 128-bit product folds with that and
2^96 = -1 (mod p).  Public functions return canonical values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as G
from .gl_tables import SPONGE_IV, external_matrix
from . import gl_encode

NL = 4  # 16-bit limbs per felt
LB = 16
MASK = 0xFFFF
P = G.P_GL
T = G.T  # 12 lanes
RATE = G.RATE  # 8
HASHES = ("poseidon2", "monolith")


def int_limbs(x: int, n: int = NL) -> list[int]:
    """Integer -> n little-endian 16-bit limbs."""
    return [(x >> (LB * i)) & MASK for i in range(n)]


def pack(values, device=None) -> torch.Tensor:
    """Iterable of python ints (< 2^64) -> (4, B) int32 limb planes."""
    values = list(values)
    arr = np.array([int_limbs(v) for v in values], dtype=np.int32).reshape(len(values), NL)
    return torch.from_numpy(arr.T.copy()).to(device)


def unpack(limbs: torch.Tensor) -> list[int]:
    """(4, B) limb planes -> list of python ints."""
    arr = limbs.detach().cpu().numpy().astype(np.int64)
    return [sum(int(arr[i, b]) << (LB * i) for i in range(NL)) for b in range(arr.shape[1])]


def _limb_table(vals) -> np.ndarray:
    """Nested lists of ints -> int32 array with a trailing limb axis of 4."""
    arr = np.asarray(vals, dtype=object)
    out = np.zeros(arr.shape + (NL,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        out[idx] = int_limbs(int(arr[idx]))
    return out


def _tables() -> dict[str, torch.Tensor]:
    """The constant tables of fields/goldilocks.py as int32 limb arrays
    (trailing limb axis): ext_rc (8, 12, 4), int_rc (22, 4), diag (12, 4)
    holding mu_i - 1 of the internal matrix J + diag(mu - 1), iv (4,)
    (the capacity IV, lane 11), keys (4, 4) (Merkle keys 0..3) and
    mono_rc (6, 12, 4)."""
    tabs = {
        "ext_rc": G.P2GL_EXTERNAL_RC,
        "int_rc": G.P2GL_INTERNAL_RC,
        "diag": [(d - 1) % P for d in G.P2GL_INTERNAL_DIAG],
        "iv": SPONGE_IV,
        "keys": list(range(4)),
        "mono_rc": G.MONOLITH_RC,
    }
    return {k: torch.from_numpy(_limb_table(v)) for k, v in tabs.items()}


TABLES = _tables()


# ---------------------------------------------------------------------------
# Field arithmetic on int64 limb columns (limb axis first)


def _ripple(cols: torch.Tensor):
    """Signed limb columns (k, *S) -> (16-bit limbs (k, *S), signed carry
    out of the top limb (*S))."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + carry
        out[k] = v & MASK
        carry = v >> LB
    return out, carry


def _settle(cols: torch.Tensor) -> torch.Tensor:
    """Signed 4-limb columns of a value in (-2^64, 2^80) -> loose limbs of
    the same residue.  Each carry c out of the top limb folds back as
    c * (2^32 - 1) = c * 0xFFFF * (1 + 2^16); two folds leave no carry."""
    x, c = _ripple(cols)
    for _ in range(2):
        e = c * MASK
        x[0] += e
        x[1] += e
        x, c = _ripple(x)
    return x


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _settle(a + b)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Loose x loose -> loose.  16 products of 16-bit limbs into 8 columns
    (each below 2^34), then n = A*2^96 + B*2^64 + C = C + B*2^32 - B - A."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    cols = a.new_zeros((2 * NL,) + shape[1:])
    for i in range(NL):
        cols[i : i + NL] += a[i] * b
    limb, _ = _ripple(cols)
    return _settle(torch.stack([
        limb[0] - limb[4] - limb[6],
        limb[1] - limb[5] - limb[7],
        limb[2] + limb[4],
        limb[3] + limb[5],
    ]))


@functools.lru_cache(maxsize=None)
def _p_col(device: torch.device, ndim: int) -> torch.Tensor:
    return torch.tensor(int_limbs(P), dtype=torch.int64, device=device).reshape(
        (NL,) + (1,) * (ndim - 1)
    )


def _canon(x: torch.Tensor) -> torch.Tensor:
    """Loose -> canonical: x - p where that does not borrow."""
    d, borrow = _ripple(x - _p_col(x.device, x.ndim))
    return torch.where(borrow == 0, d, x)


def _matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Small-integer (12, 12) matrix times loose (4, 12, B) lanes: limb
    columns stay below (row sum) * 2^16 before one settle."""
    return _settle((m[:, :, None] * x[:, None, :, :]).sum(2))


def _sbox7(x: torch.Tensor) -> torch.Tensor:
    x2 = _mul(x, x)
    x4 = _mul(x2, x2)
    return _mul(_mul(x4, x2), x)


def gl_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on (4, *S) limb planes of values below 2^64."""
    return _canon(_add(a.to(torch.int64), b.to(torch.int64))).to(a.dtype)


def gl_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p on (4, *S) limb planes of values below 2^64."""
    return _canon(_mul(a.to(torch.int64), b.to(torch.int64))).to(a.dtype)


# ---------------------------------------------------------------------------
# The permutations on loose (4, 12, B) int64 states


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict[str, torch.Tensor]:
    """The tables as int64 limb columns broadcastable against (4, 12, B)."""
    t = {k: v.to(device, torch.int64) for k, v in TABLES.items()}
    return {
        "ext_rc": t["ext_rc"].permute(0, 2, 1)[..., None],  # (8, 4, 12, 1)
        "int_rc": t["int_rc"][:, :, None, None],  # (22, 4, 1, 1)
        "diag": t["diag"].T[..., None],  # (4, 12, 1)
        "iv": t["iv"][:, None],  # (4, 1)
        "mono_rc": t["mono_rc"].permute(0, 2, 1)[..., None],  # (6, 4, 12, 1)
        "ext_mat": torch.tensor(external_matrix(), dtype=torch.int64, device=device),
        "concrete": torch.tensor(G.MONOLITH_CONCRETE, dtype=torch.int64, device=device),
    }


def _poseidon2(s: torch.Tensor) -> torch.Tensor:
    """Poseidon2-GL t=12 (oracle/goldilocks.py poseidon2_permutation): the
    initial external layer, 4 external rounds, 22 internal, 4 external."""
    c = _consts(s.device)

    def external(s, r):
        return _matvec(c["ext_mat"], _sbox7(_add(s, c["ext_rc"][r])))

    s = _matvec(c["ext_mat"], s)
    for r in range(G.RF // 2):
        s = external(s, r)
    for k in range(G.RP):
        s = torch.cat([_sbox7(_add(s[:, 0:1], c["int_rc"][k])), s[:, 1:]], 1)
        s = _add(_settle(s.sum(1, keepdim=True)), _mul(s, c["diag"]))
    for r in range(G.RF // 2, G.RF):
        s = external(s, r)
    return s


def _bar_limbs(x: torch.Tensor) -> torch.Tensor:
    """The 8-bit Monolith bar on both bytes of every 16-bit limb:
    bar(b) = rotl1(b ^ (rotl1(~b) & rotl2(b) & rotl3(b)))."""

    def rot(v, k):
        return ((v << k) | (v >> (8 - k))) & 0xFF

    def bar(b):
        return rot(b ^ (rot(~b & 0xFF, 1) & rot(b, 2) & rot(b, 3)), 1)

    return bar(x & 0xFF) | (bar(x >> 8) << 8)


def _monolith(s: torch.Tensor) -> torch.Tensor:
    """Monolith-64 t=12 (oracle/goldilocks.py monolith_permutation): the
    initial Concrete, then 6 rounds of Bars, Bricks, Concrete, constants."""
    c = _consts(s.device)
    nb = G.MONOLITH_BARS
    s = _matvec(c["concrete"], s)
    for r in range(G.MONOLITH_ROUNDS):
        # Bars: a bytewise map of the canonical value, reduced again after
        bars = _canon(_bar_limbs(_canon(s[:, :nb])))
        s = torch.cat([bars, s[:, nb:]], 1)
        # Bricks: x_i += x_{i-1}^2, with the squares of the input lanes
        sq = _mul(s[:, : T - 1], s[:, : T - 1])
        s = torch.cat([s[:, :1], _add(s[:, 1:], sq)], 1)
        s = _add(_matvec(c["concrete"], s), c["mono_rc"][r])
    return s


_CORES = {"poseidon2": _poseidon2, "monolith": _monolith}


def _core(hash_fun: str):
    """The permutation of one hash on an int64 (4, 12, B) state, run under
    inference mode (no autograd dispatch on each of its many small ops) and
    cloned out of it, so that callers may update the result in place."""
    if hash_fun not in _CORES:
        raise ValueError(f"unknown hash {hash_fun!r}: expected one of {HASHES}")
    core = _CORES[hash_fun]

    def run(s: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            s = core(s)
        return s.clone()

    return run


def permutation(state: torch.Tensor, hash_fun: str = "poseidon2") -> torch.Tensor:
    """(12, 4, B) states (values below 2^64) -> permuted canonical states."""
    if state.shape[:2] != (T, NL):
        raise ValueError(f"permutation: state shape {tuple(state.shape)} is not (12, 4, B)")
    s = _core(hash_fun)(state.to(torch.int64).transpose(0, 1))
    return _canon(s).transpose(0, 1).to(state.dtype)


def poseidon2_gl_permutation(state: torch.Tensor) -> torch.Tensor:
    return permutation(state, "poseidon2")


def monolith_permutation(state: torch.Tensor) -> torch.Tensor:
    return permutation(state, "monolith")


def compress_batch(hash_fun: str, key, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Keyed 2-digest compression: lanes 0..3 of perm(x || y || key,0,0,0).

    x, y: (4, 4, B) digest batches; key: an int or a (4, B) limb plane.
    Returns (4, 4, B) canonical digests.
    """
    b = x.shape[-1]
    if isinstance(key, int):
        key = torch.tensor(int_limbs(key), dtype=x.dtype, device=x.device)[:, None]
    key = key.to(x.device, x.dtype).expand(NL, b)
    zero = x.new_zeros((3, NL, b))
    state = torch.cat([x, y.to(x.dtype), key[None], zero], 0)
    return permutation(state, hash_fun)[:4]


def tree_layers(hash_fun: str, layer: torch.Tensor, levels: int,
                key_bits: int) -> list[torch.Tensor]:
    """The `levels` keyed compression layers above a (4, 4, W) digest
    layer, one compress_batch a layer: layer j + 1 pairs the columns of
    layer j with key (key_bits >> j) & 1.  The plain version of the subtree
    kernel (goldilocks_cuda.tree_layers)."""
    out = []
    for j in range(levels):
        layer = compress_batch(hash_fun, (key_bits >> j) & 1, layer[:, :, 0::2], layer[:, :, 1::2])
        out.append(layer)
    return out


def sponge_digest_felts(hash_fun: str, felts: torch.Tensor) -> torch.Tensor:
    """Rate-8 sponge over (n, 4, B) felts with `10*` felt padding (append a
    1, zero-fill to a multiple of 8); the capacity IV sits in lane 11 and
    each block adds into lanes 0..7.  Returns the (4, 4, B) digests."""
    core = _core(hash_fun)
    n, nl, b = felts.shape
    if nl != NL:
        raise ValueError(f"sponge_digest_felts: felts shape {tuple(felts.shape)}")
    total = n + 1 + (-(n + 1)) % RATE
    blocks = felts.new_zeros((total, NL, b), dtype=torch.int64)
    blocks[:n] = felts
    blocks[n, 0] = 1
    blocks = blocks.reshape(total // RATE, RATE, NL, b).transpose(1, 2)  # (nb, 4, 8, B)
    s = blocks.new_zeros((NL, T, b))
    s[:, T - 1] = _consts(felts.device)["iv"]
    for blk in blocks:
        s = core(torch.cat([_add(s[:, :RATE], blk), s[:, RATE:]], 1))
    return _canon(s[:, :4]).transpose(0, 1).to(felts.dtype)


def sponge_digest_rows(hash_fun: str, rows: torch.Tensor) -> torch.Tensor:
    """Cell digests of (cell_size, B) byte rows (byte i of every cell in row
    i; any integer dtype and strides) -> (4, 4, B): the 62-byte chunk encode
    with `10*` byte padding, then the rate-8 sponge."""
    return sponge_digest_felts(hash_fun, gl_encode.encode_rows(rows))
