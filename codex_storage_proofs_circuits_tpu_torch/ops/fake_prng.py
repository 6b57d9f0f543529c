"""Fake-data PRNG: the plain torch recurrence on 16-bit limbs, and the
wrapper of the CUDA kernel K3 (csrc/fake_prng.cu).

Port of codex_storage_proofs_circuits_tpu/ops/fake_prng.py.  The reference
mock backend (slot.nim:22-32 == oracle/slot.py gen_fake_cell) steps, per
byte, a uint64 state with deliberate wraparound and a final
`mod 1698428844001831`.  Sequential along the byte axis, independent across
cells: the batch of cells lies on the last axis and each step emits one
byte row, so a chunk's bytes come out as (cell_size, B) rows.

The plain version keeps uint64 values as four 16-bit limbs in int64
tensors, as the JAX twin does: torch's int64 is signed and its `>>` is
arithmetic, so native wraparound is not safe there.  Products are 16x16 ->
32 bit, and the modulo is Barrett with a 14-bit quotient.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..oracle.slot import FAKE_MODULUS

from ..kernels import build
from .limbs import MASK, int_limbs

_M = FAKE_MODULUS  # 1698428844001831 < 2^51
_MU = (1 << 101) // _M  # Barrett reciprocal, < 2^51
_M_LIMBS = int_limbs(_M, 4)
_MU_LIMBS = int_limbs(_MU, 4)
_XOR_C = int_limbs(0x5A5A5A5A, 4)


def _ripple(cols):
    """Carry-resolve limb columns; the carry out of the top limb is dropped."""
    outs = []
    carry = 0
    for col in cols:
        c = col + carry
        outs.append(c & MASK)
        carry = c >> 16
    return outs


def _add64(a, b):
    """(a + b) mod 2^64 on 4-limb lists (b may hold python ints)."""
    return _ripple([a[i] + b[i] for i in range(4)])


def _mul64(a, b):
    """(a * b) mod 2^64: lower 4 limb columns of the product."""
    cols = [0] * 4
    for i in range(4):
        for j in range(4 - i):
            p = a[i] * b[j]
            cols[i + j] = cols[i + j] + (p & MASK)
            if i + j + 1 < 4:
                cols[i + j + 1] = cols[i + j + 1] + (p >> 16)
    return _ripple(cols)


def _mul_limb(a, b: list[int], n_out: int):
    """Product of a one-limb value by the constant limbs b, n_out limbs."""
    cols = [0] * n_out
    for j, bj in enumerate(b):
        p = a * bj
        cols[j] = cols[j] + (p & MASK)
        cols[j + 1] = cols[j + 1] + (p >> 16)
    return _ripple(cols)


def _cond_sub_m(a):
    """a - M where a >= M else a (a < 2^64)."""
    gt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for i in range(3, -1, -1):
        gt = gt | (eq & (a[i] > _M_LIMBS[i]))
        eq = eq & (a[i] == _M_LIMBS[i])
    do = (gt | eq).to(torch.int64)
    out = []
    borrow = 0
    for i in range(4):
        d = a[i] - do * _M_LIMBS[i] - borrow
        out.append(d & MASK)
        borrow = (d >> 31) & 1
    return out


def _mod_m(v):
    """v (4 limbs, < 2^64) mod M via Barrett: q = ((v >> 50) * MU) >> 51,
    q <= floor(v/M) <= q + 2, so two conditional subtracts finish.  q is a
    single limb: floor(v/M) < 2^64 / 2^50.59 < 2^13.5."""
    top = (v[3] >> 2) & 0x3FFF  # v >> 50
    prod = _mul_limb(top, _MU_LIMBS, 5)  # top * MU, < 2^65
    q = ((prod[3] >> 3) | (prod[4] << 13)) & MASK  # (top * MU) >> 51
    qm = _mul_limb(q, _M_LIMBS, 5)  # q*M <= v
    r = []
    borrow = 0
    for i in range(4):
        d = v[i] - qm[i] - borrow
        r.append(d & MASK)
        borrow = (d >> 31) & 1
    for _ in range(2):
        r = _cond_sub_m(r)
    return r


def _prng_step(s, s1l, s2l, xor_c, s2p17):
    """One recurrence step on 4-limb lists of (B,) int64 planes.

    s(s+s1)(s+s2) + s(s^C) + s1*s + s2 + 17
      == s * [(s+s1)(s+s2) + (s^C) + s1] + s2 + 17   (mod 2^64), then mod M.
    """
    inner = _mul64(_add64(s, s1l), _add64(s, s2l))
    inner = _add64(inner, [s[i] ^ xor_c[i] for i in range(4)])
    inner = _add64(inner, s1l)
    return _mod_m(_add64(_mul64(s, inner), s2p17))


def fake_seed_bases(seed: int, start_idx: int, device=None):
    """(seed1, seed2 base) as (4,) int32 16-bit limb vectors on device: the
    32 bytes from which a chunk's per-cell seeds derive (seed_planes)."""
    seed1 = (seed + 0xDEADCAFE) & 0xFFFFFFFFFFFFFFFF
    base2 = (start_idx + 0x98765432) & 0xFFFFFFFFFFFFFFFF
    both = np.array([int_limbs(seed1, 4), int_limbs(base2, 4)], dtype=np.int32)
    t = torch.from_numpy(both).to(device)
    return t[0], t[1]


def seed_planes(seed1_base: torch.Tensor, seed2_base: torch.Tensor, n: int):
    """Per-cell seed planes (s1, s2), each (4, n) int32: s1 broadcast from
    its base, s2 = base + cell offset with 64-bit wraparound (n <= 2^32)."""
    b1 = seed1_base.to(torch.int64)
    b2 = seed2_base.to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=seed2_base.device)
    cols = [b2[0] + (iota & MASK), b2[1] + (iota >> 16), b2[2].expand(n), b2[3].expand(n)]
    s1 = b1[:, None].expand(4, n)
    return s1.to(torch.int32), torch.stack(_ripple(cols)).to(torch.int32)


def gen_rows_plain(seed1_planes: torch.Tensor, seed2_planes: torch.Tensor, n_steps: int):
    """Seed planes (4, B) -> (n_steps, B) uint8 byte rows."""
    s1 = [seed1_planes[i].to(torch.int64) for i in range(4)]
    s2 = [seed2_planes[i].to(torch.int64) for i in range(4)]
    s2p17 = _add64(s2, [17, 0, 0, 0])
    one = torch.ones_like(s1[0])
    s = [one, one * 0, one * 0, one * 0]
    out = torch.empty((n_steps, s1[0].shape[0]), dtype=torch.uint8, device=s1[0].device)
    for i in range(n_steps):
        s = _prng_step(s, s1, s2, _XOR_C, s2p17)
        out[i] = s[0] & 0xFF
    return out


def gen_rows(seed1_base: torch.Tensor, seed2_base: torch.Tensor, n_steps: int, n: int):
    """(n_steps, n) uint8 byte rows of cells base..base+n-1: kernel K3 for
    CUDA seed bases, the plain version for CPU ones.  Each launch adds one
    to kernels.build.LAUNCHES["prng"]."""
    if seed1_base.device.type == "cpu":
        return gen_rows_plain(*seed_planes(seed1_base, seed2_base, n), n_steps)
    for t in (seed1_base, seed2_base):
        build.require_cuda(t, "gen_rows", torch.int32, (4,))
        if not t.is_contiguous():
            raise ValueError("gen_rows: seed bases must be contiguous")
    out = torch.empty((n_steps, n), dtype=torch.uint8, device=seed1_base.device)
    dev, stream = build.launch_args(out)
    err = build.load().cspc_fake_prng_rows(
        ctypes.c_void_p(seed1_base.data_ptr()),
        ctypes.c_void_p(seed2_base.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        n_steps, n, dev, stream,
    )
    build.check(err, "fake PRNG kernel")
    build.LAUNCHES["prng"] += 1
    return out
