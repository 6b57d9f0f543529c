"""The reference's hashes and roots against the frozen vectors of
tests/vectors/, at small sizes: the pure-Python oracle and the plain torch
versions the judge runs."""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import judge
from port_bench.reference import fake_data, gl_oracle
from port_bench.reference import merkle as RM
from port_bench.reference import slot as RSL
from port_bench.spec import ROOT

VEC = os.path.join(ROOT, "tests", "vectors")
BN = json.load(open(os.path.join(VEC, "bn254_testvectors.json")))
GL = json.load(open(os.path.join(VEC, "gl_testvectors.json")))


def _rows(data: bytes) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8).reshape(-1, 1)


def test_bn254_cell_hash_oracle():
    for n in range(0, 81):
        assert str(RSL.hash_cell_bytes(bytes(range(1, n + 1)))) == BN["hash_bytes"][n], n


@pytest.mark.parametrize("n", [1, 30, 31, 62, 80])
def test_bn254_cell_hash_plain(n):
    got = judge.Bn254().leaves(_rows(bytes(range(1, n + 1))))
    assert str(judge.Bn254().value(got)) == BN["hash_bytes"][n]


def test_bn254_merkle_oracle():
    for n in range(1, 41):
        assert str(RM.merkle_root(list(range(1, n + 1)))) == BN["merkle_felts"][n - 1], n


def _plain_root(fld, leaves: torch.Tensor):
    layer = leaves
    d = 0
    while layer.shape[-1] > 1:
        key = RM.KEY_BOTTOM_LAYER if d == 0 else RM.KEY_NONE
        layer = fld.nodes(key, layer[..., 0::2], layer[..., 1::2])
        d += 1
    return fld.value(layer)


@pytest.mark.parametrize("n", [2, 8, 16])
def test_bn254_merkle_plain(n):
    from port_bench.reference import limbs as L

    assert str(_plain_root(judge.Bn254(), L.pack(range(1, n + 1)))) == BN["merkle_felts"][n - 1]


@pytest.mark.parametrize("hf", ["poseidon2", "monolith"])
def test_gl_cell_digest(hf):
    fld = judge.Goldilocks(hf)
    for n in (1, 61, 62, 130):
        data = bytes((i % 256) for i in range(1, n + 1))
        want = tuple(int(s) for s in GL[hf]["digest_bytes"][n])
        assert gl_oracle.digest_bytes(hf, data) == want, n
        assert fld.value(fld.leaves(_rows(data))) == want, n


@pytest.mark.parametrize("hf", ["poseidon2", "monolith"])
def test_gl_merkle(hf):
    from port_bench.reference import gl_plain as GP

    fld = judge.Goldilocks(hf)
    for n in (2, 8, 16):
        want = tuple(int(s) for s in GL[hf]["merkle_felts"][n - 1])
        leaves = [gl_oracle.int_to_digest(k) for k in range(1, n + 1)]
        assert RM.merkle_tree(leaves, gl_oracle.compress_fn(hf)).root == want
        planes = torch.stack([GP.pack([d[j] for d in leaves]) for j in range(4)])
        assert _plain_root(fld, planes) == want


def test_fake_cells_match_the_scalar_generator():
    seed = 2**33 + 5
    idx = [0, 1, 77, 2**19 - 1]
    got = fake_data.gen_fake_cells(2048, seed, idx)
    for row, i in zip(got, idx):
        assert row.tobytes() == RSL.gen_fake_cell(2048, seed, i)
    assert got.dtype == np.uint8
