#!/usr/bin/env python
"""Regenerate the frozen Goldilocks test-vector suites from the port's oracle.

The twin of tools/gen_gl_vectors.py, with its imports pointed into the
port's copy of the oracle; for both GL hash instances:

  digest_felts   : digest([1..n])                   n = 0..17 (sweeps the
                   10* felt padding across two rate-8 blocks)
  digest_bytes   : digest_bytes([1..n])             n = 0..130 (sweeps the
                   `10*` byte padding across 62-byte chunk boundaries)
  merkle_felts   : root of [intToDigest(1..n)]      n = 1..40 (odd/even/
                   singleton layer shapes)

    python3 -m tools_torch.gen_gl_vectors [--out DIR]

writes DIR/gl_testvectors.json (default DIR: build/vectors/ at the root of
the checkout), which must equal tests/vectors/gl_testvectors.json byte for
byte; the frozen file itself is never written.
"""

from __future__ import annotations

import argparse
import json
import os

from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks import (
    compress_fn,
    digest_bytes,
    digest_felts,
    int_to_digest,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.merkle import merkle_tree

from tools_torch.gen_vectors import DEFAULT_OUT


def vectors() -> dict:
    out = {}
    for hf in ("poseidon2", "monolith"):
        comp = compress_fn(hf)
        out[hf] = {
            "digest_felts": [
                [str(v) for v in digest_felts(hf, range(1, n + 1))]
                for n in range(0, 18)
            ],
            "digest_bytes": [
                [str(v) for v in digest_bytes(hf, bytes((i % 256) for i in range(1, n + 1)))]
                for n in range(0, 131)
            ],
            "merkle_felts": [
                [str(v) for v in merkle_tree(
                    [int_to_digest(i) for i in range(1, n + 1)], comp
                ).root]
                for n in range(1, 41)
            ],
        }
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "gl_testvectors.json")
    with open(out, "w") as f:
        json.dump(vectors(), f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
