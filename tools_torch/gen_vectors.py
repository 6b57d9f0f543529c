#!/usr/bin/env python
"""Regenerate the frozen BN254 test-vector suites from the port's oracle.

The twin of tools/gen_vectors.py, with its imports pointed into the port's
copy of the oracle.  The suites mirror the reference's cross-implementation
vector programs (reference/nim/testvectors/src/testvectors.nim:20-72 ==
reference/haskell/src/TestVectors.hs:28-75):

  sponge_rate1_felts : sponge1([1..n])              n = 0..8
  sponge_rate2_felts : sponge2([1..n])              n = 0..8
  hash_bytes         : hash_cell_bytes([1..n])      n = 0..80  (sweeps all
                       `10*` padding cases across 31-byte chunk boundaries)
  merkle_felts       : merkle_root([1..n])          n = 1..40  (odd/even/
                       singleton layer shapes)
  merkle_bytes       : merkle_root(felts([1..n]))   n = 0..80

    python3 -m tools_torch.gen_vectors [--out DIR]

writes DIR/bn254_testvectors.json (default DIR: build/vectors/ at the root
of the checkout), which must equal tests/vectors/bn254_testvectors.json
byte for byte; the frozen file itself is never written.
"""

from __future__ import annotations

import argparse
import json
import os

from codex_storage_proofs_circuits_tpu_torch.oracle.merkle import merkle_root
from codex_storage_proofs_circuits_tpu_torch.oracle.poseidon2 import sponge1, sponge2
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import (
    cell_data_to_field_elements,
    hash_cell_bytes,
)

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build", "vectors")


def vectors() -> dict:
    return {
        "sponge_rate1_felts": [
            str(sponge1(range(1, n + 1))) for n in range(0, 9)
        ],
        "sponge_rate2_felts": [
            str(sponge2(range(1, n + 1))) for n in range(0, 9)
        ],
        "hash_bytes": [
            str(hash_cell_bytes(bytes(range(1, n + 1)))) for n in range(0, 81)
        ],
        "merkle_felts": [
            str(merkle_root(list(range(1, n + 1)))) for n in range(1, 41)
        ],
        "merkle_bytes": [
            str(merkle_root(cell_data_to_field_elements(bytes(range(1, n + 1)))))
            for n in range(0, 81)
        ],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "bn254_testvectors.json")
    with open(out, "w") as f:
        json.dump(vectors(), f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
