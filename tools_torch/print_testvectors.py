#!/usr/bin/env python
"""Print the cross-implementation test-vector suites as diffable text,
computed by the port on a device.

The `GPU |` twin of tools/print_testvectors.py, which prints the
reference's suites (reference/nim/testvectors/src/testvectors.nim:20-72)
with a `TPU |` prefix.  The same lines come out here, each value computed
through the port's functions on the given device: the rate-2 sponges by
the cell hash (kernel K2's limb-plane entry on the card), the Merkle roots
by the keyed tree build (K1), the rate-1 sponge, which has no entry in the
port, over the permutation (K1); the bytes encode through ops/encode.py.

    python3 -m tools_torch.print_testvectors [--device=cuda|cpu]
    diff <(python tools/print_testvectors.py | sed 's/^TPU /X /') \\
         <(python3 -m tools_torch.print_testvectors | sed 's/^GPU /X /')

shows nothing when the two agree.  Without a card --device=cuda fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.ops import encode as E
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as L
from codex_storage_proofs_circuits_tpu_torch.oracle.poseidon2 import SPONGE1_IV
from codex_storage_proofs_circuits_tpu_torch.parallel.mesh import cuda_devices

NL = L.NL


def _mont(values, device) -> torch.Tensor:
    return L.to_mont(L.pack(values, device))


def sponges1(inputs: list[list[int]], device) -> list[int]:
    """The rate-1 sponge (`10*` felt padding) of each felt list, all lists
    in one batch: step k absorbs felt k of every list that has one and
    keeps the other lanes' states.  The port has no rate-1 entry: this is
    the sponge over its permutation."""
    padded = [list(xs) + [1] for xs in inputs]
    b = len(inputs)
    st = torch.stack([_mont([0] * b, device), _mont([0] * b, device),
                      _mont([SPONGE1_IV] * b, device)])
    for k in range(max(len(xs) for xs in padded)):
        blk = _mont([xs[k] if k < len(xs) else 0 for xs in padded], device)
        nxt = H.permute(torch.stack([L.add_mod(st[0], blk), st[1], st[2]]))
        live = torch.tensor([k < len(xs) for xs in padded], device=device)
        st = torch.where(live, nxt, st)
    return L.unpack(L.from_mont(st[0]))


def sponges2(inputs: list[list[int]], device) -> list[int]:
    """The rate-2 sponge of each felt list through the port's cell hash
    (models/hashing.hash_cells_mont), one call for the lists of each
    length."""
    out = [0] * len(inputs)
    for n in sorted({len(xs) for xs in inputs}):
        idx = [i for i, xs in enumerate(inputs) if len(xs) == n]
        cols = [L.pack([inputs[i][j] for i in idx], device) for j in range(n)]
        felts = (torch.stack(cols) if cols
                 else torch.zeros((0, NL, len(idx)), dtype=torch.int32, device=device))
        hashes = L.unpack(L.from_mont(H.hash_cells_mont(felts)))
        for i, h in zip(idx, hashes):
            out[i] = h
    return out


def merkle_roots(leaves: list[list[int]], device) -> list[int]:
    """The keyed Merkle root of each leaf list, all trees at once through
    models/hashing.tree_reduce_general_many."""
    trees = H.tree_reduce_general_many([_mont(xs, device) for xs in leaves])
    return [L.unpack(L.from_mont(t[-1]))[0] for t in trees]


def _byte_felts(n: int) -> list[int]:
    """The felts of bytes 1..n through the port's byte encode."""
    data = torch.arange(1, n + 1, dtype=torch.uint8).reshape(1, n)
    return [v[0] for v in (L.unpack(f) for f in E.encode_cells(data))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        cuda_devices()  # raises without a card
    out = sys.stdout

    def header(title: str) -> None:
        print("", file=out)
        print(f"GPU | {title}", file=out)
        print("-" * (len(title) + 6), file=out)

    header("test vectors for sponge of field elements with rate=1")
    for n, h in enumerate(sponges1([list(range(1, n + 1)) for n in range(9)], device)):
        print(f"hash of [1..{n}] : seq[F] =  {h}", file=out)

    header("test vectors for sponge of field elements with rate=2")
    for n, h in enumerate(sponges2([list(range(1, n + 1)) for n in range(9)], device)):
        print(f"hash of [1..{n}] : seq[F] =  {h}", file=out)

    byte_felts = [_byte_felts(n) for n in range(81)]
    header("test vectors for hash (padded sponge with rate=2) of bytes")
    for n, h in enumerate(sponges2(byte_felts, device)):
        print(f"hash of [1..{n}] : seq[byte] =  {h}", file=out)

    header("test vectors for Merkle roots of field elements")
    roots = merkle_roots([list(range(1, n + 1)) for n in range(1, 41)], device)
    for n, r in enumerate(roots, start=1):
        print(f"Merkle root of [1..{n}] : seq[F] =  {r}", file=out)

    header("test vectors for Merkle roots of sequence of bytes")
    for n, r in enumerate(merkle_roots(byte_felts, device)):
        print(f"Merkle root of [1..{n}] : seq[byte] =  {r}", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
