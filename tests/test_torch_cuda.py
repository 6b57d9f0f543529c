"""The CUDA kernels K1-K6 against their plain torch versions, and the
slices on the card against the oracle, bit-exact.  K2 and K6 are held on
both their entries: byte rows (the main path's, in the PRNG's contiguous
(cell_size, B) layout and as a (B, cell_size).T view) and limb planes,
each with its own launch count.

Every test here needs a CUDA device (and nvcc) and skips without one.  The
file imports no jax, so it also runs on a machine with the card and no jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu_torch.fields import bn254 as F
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks as GO
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
    generate_proof_input_gl as oracle_pi_gl,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.sampling import generate_proof_input as oracle_pi
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, gen_fake_cell
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.models import gl_proof_input as TGPI
from codex_storage_proofs_circuits_tpu_torch.models import proof_input as TPI
from codex_storage_proofs_circuits_tpu_torch.ops import fake_prng as TF
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as TGC
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TGP
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as TC
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as TP
from codex_storage_proofs_circuits_tpu_torch import parallel as TPAR
from codex_storage_proofs_circuits_tpu_torch.models import circuit as TCIRC
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _canonical(rng, shape):
    arr = rng.integers(0, 1 << 16, size=shape, dtype=np.int32)
    arr[..., 15, :] = rng.integers(0, F.P >> 240, size=arr[..., 15, :].shape)
    return torch.from_numpy(arr)


def test_permutation_and_compress_match_plain(cuda):
    rng = np.random.default_rng(41)
    state = _canonical(rng, (3, 16, 257))  # not a multiple of the block size
    before = build.LAUNCHES["perm"]
    assert torch.equal(TC.permutation(state.to(cuda)).cpu(), TP.permutation(state))
    layer = state[0][:, :256]
    for key in range(4):
        got = TC.compress_layer(layer.to(cuda)[:, 0::2], layer.to(cuda)[:, 1::2], key)
        want = TP.compress(layer[:, 0::2], layer[:, 1::2], TP.KEY_MONT[key])
        assert torch.equal(got.cpu(), want)
    assert build.LAUNCHES["perm"] == before + 5
    with pytest.raises(ValueError):  # odd width: the halves differ
        TC.compress_layer(state[0].to(cuda)[:, 0::2], state[0].to(cuda)[:, 1::2], 0)
    kat = torch.stack([TL.pack([F.to_mont(v)], cuda) for v in F.PERMUTATION_KAT_INPUT])
    out = TC.permutation(kat)
    assert tuple(F.from_mont(TL.unpack(out[k])[0]) for k in range(3)) == F.PERMUTATION_KAT_OUTPUT


def test_sponge2_matches_plain(cuda):
    rng = np.random.default_rng(42)
    blocks = _canonical(rng, (5, 2, 16, 130))
    before = build.LAUNCHES["sponge2_planes"]
    got = TC.sponge2_absorb(blocks.to(cuda))
    assert torch.equal(got.cpu(), TP.sponge2_absorb(blocks))
    assert build.LAUNCHES["sponge2_planes"] == before + 1
    with pytest.raises(ValueError):
        TC.sponge2_absorb(blocks.to(cuda).transpose(0, 1))  # not (nb, 2, 16, B)


CELL_SIZES = [30, 31, 61, 62, 2048]  # both felt parities, markers opening a felt / chunk


def _cells(cell_size: int) -> np.ndarray:
    # 257 cells: not a multiple of the 128-thread block
    cells = np.random.default_rng(cell_size).integers(0, 256, (257, cell_size), dtype=np.uint8)
    cells[0] = 0xFF
    return cells


@pytest.mark.parametrize("cell_size", CELL_SIZES)
def test_sponge2_rows_matches_plain(cuda, cell_size):
    cells = _cells(cell_size)
    want = TP.sponge2_rows(torch.from_numpy(cells.T.copy()))
    before = build.LAUNCHES["sponge2"]
    for rows in (torch.from_numpy(cells.T.copy()).to(cuda), torch.from_numpy(cells).to(cuda).T):
        assert torch.equal(TC.sponge2_rows(rows).cpu(), want)
    assert build.LAUNCHES["sponge2"] == before + 2
    with pytest.raises(ValueError):  # bytes only
        TC.sponge2_rows(torch.from_numpy(cells.T.copy()).to(cuda, torch.int32))


@pytest.mark.parametrize("cell_size", CELL_SIZES)
@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_gl_sponge_rows_matches_plain(cuda, hash_fun, cell_size):
    cells = _cells(cell_size)
    counter = {"poseidon2": "gl_sponge8", "monolith": "mono_sponge8"}[hash_fun]
    want = TGP.sponge_digest_rows(hash_fun, torch.from_numpy(cells.T.copy()))
    before = build.LAUNCHES[counter]
    for rows in (torch.from_numpy(cells.T.copy()).to(cuda), torch.from_numpy(cells).to(cuda).T):
        assert torch.equal(TGC.sponge_digest_rows(rows, hash_fun).cpu(), want)
    assert build.LAUNCHES[counter] == before + 2


def test_prng_matches_plain_and_oracle(cuda):
    s1, s2 = TF.fake_seed_bases(424242, 11, cuda)
    got = TF.gen_rows(s1, s2, 64, 4099)
    assert torch.equal(got, TF.gen_rows_plain(*TF.seed_planes(s1, s2, 4099), 64))
    assert got[:, 4098].cpu().numpy().tobytes() == gen_fake_cell(64, 424242, 11 + 4098)


def test_slice_on_cuda_matches_oracle(cuda):
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=4,
                         data_src=DataSource("fake", seed=5))
    want = oracle_pi(glob, dset, 1, 7)
    assert TPI.generate_proof_input(glob, dset, 1, 7, device=cuda) == want
    got = TPI.generate_proof_input_streaming(glob, dset, 1, 7, chunk_cells=8, device=cuda)
    assert got == want


def _gl_planes(rng, shape):
    """Random (..., 4, B) limb planes of values below 2^64 (not all < p)."""
    return torch.from_numpy(rng.integers(0, 1 << 16, size=shape, dtype=np.int32))


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_gl_permutation_and_compress_match_plain(cuda, hash_fun):
    rng = np.random.default_rng(43)
    counter = {"poseidon2": "gl_perm", "monolith": "mono_perm"}[hash_fun]
    before = build.LAUNCHES[counter]
    state = _gl_planes(rng, (12, 4, 257))
    assert torch.equal(TGC.permutation(state.to(cuda), hash_fun).cpu(),
                       TGP.permutation(state, hash_fun))
    layer = _gl_planes(rng, (4, 4, 256))
    for key in range(4):
        got = TGC.compress(layer.to(cuda)[:, :, 0::2], layer.to(cuda)[:, :, 1::2], key, hash_fun)
        want = TGP.compress_batch(hash_fun, key, layer[:, :, 0::2], layer[:, :, 1::2])
        assert torch.equal(got.cpu(), want)
    assert build.LAUNCHES[counter] == before + 5
    kat = torch.stack([TGP.pack([v], cuda) for v in range(12)])
    out = TGC.permutation(kat, hash_fun)
    assert [TGP.unpack(out[i])[0] for i in range(12)] == GO.PERMUTATIONS[hash_fun](list(range(12)))
    with pytest.raises(ValueError):  # odd width: the halves differ
        TGC.compress(state[:4].to(cuda)[:, :, 0::2], state[:4].to(cuda)[:, :, 1::2], 0, hash_fun)


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_gl_sponge_matches_plain(cuda, hash_fun):
    rng = np.random.default_rng(44)
    counter = {"poseidon2": "gl_sponge8_planes", "monolith": "mono_sponge8_planes"}[hash_fun]
    before = build.LAUNCHES[counter]
    for n in (1, 7, 8, 15, 16, 272):
        felts = _gl_planes(rng, (n, 4, 130))
        got = TGC.sponge_digest_felts(felts.to(cuda), hash_fun)
        assert torch.equal(got.cpu(), TGP.sponge_digest_felts(hash_fun, felts))
    assert build.LAUNCHES[counter] == before + 6


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_gl_slice_on_cuda_matches_oracle(cuda, hash_fun):
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=4,
                         data_src=DataSource("fake", seed=5))
    entropy = GO.int_to_digest(7)
    want = oracle_pi_gl(hash_fun, glob, dset, 1, entropy)
    assert TGPI.generate_proof_input_gl(hash_fun, glob, dset, 1, entropy, device=cuda) == want
    got = TGPI.generate_proof_input_gl_streaming(hash_fun, glob, dset, 1, entropy,
                                                 chunk_cells=8, device=cuda)
    assert got == want


# (width, trees side by side, subtree launches): one tree of 1, 2, 2^7, 2^8
# and 2^9 digests and four trees of 2^7 (one CTA: at most 2^11 digests);
# 2^12 and two trees of 2^12 (a launch of CTAs of 2^11 digests, then one
# CTA), 64 trees of 64 in CTAs of 2^11 (each CTA's tile holds 32 trees),
# and one main-path chunk of 2^18 digests
TREE_CASES = [(1, 1, 0), (2, 1, 1), (128, 1, 1), (256, 1, 1), (512, 1, 1), (512, 4, 1),
              (4096, 1, 2), (8192, 2, 2), (4096, 64, 1), (1 << 18, 1, 2)]


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_gl_subtree_matches_plain(cuda, hash_fun):
    rng = np.random.default_rng(45)
    counter = {"poseidon2": "gl_perm", "monolith": "mono_perm"}[hash_fun]
    for w, stop, launches in TREE_CASES:
        layer = _gl_planes(rng, (4, 4, w)).to(cuda)
        levels = (w // stop).bit_length() - 1
        key_bits = 0b100001 if w == 1 << 18 else int(rng.integers(0, 1 << 20))
        want = TGP.tree_layers(hash_fun, layer, levels, key_bits)
        before = build.LAUNCHES[counter]
        got = TGC.tree_layers(layer, hash_fun, levels, key_bits, stop)
        assert build.LAUNCHES[counter] == before + launches, (w, stop)
        assert len(got) == levels and (w == stop or got[-1].shape == (4, 4, stop))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (w, stop)
    view = _gl_planes(rng, (4, 4, 2 * 4096)).to(cuda)[:, :, 1::2]  # a strided layer
    assert all(torch.equal(a, b) for a, b in zip(TGC.tree_layers(view, hash_fun, 12, 5),
                                                 TGP.tree_layers(hash_fun, view, 12, 5)))


# (width, trees side by side, subtree launches) of the BN254 subtree entry:
# one tree of 2 and 2^7 nodes and 2^8, one CTA's; 2^9, just past it (a
# launch of CTAs of 2^8 nodes, then one CTA); four trees of 2^7 (one launch
# of two CTAs); 2^15, a 1 GB slot's frontier (128 CTAs, then one CTA); a
# main-path chunk of 2^18 to its root (CTAs of 2^11 nodes, then one CTA)
# and cut at 2^14 nodes (one launch of 4 levels)
P2_TREE_CASES = [(2, 1, 1), (128, 1, 1), (256, 1, 1), (512, 1, 2), (512, 4, 1),
                 (1 << 15, 1, 2), (1 << 18, 1, 2), (1 << 18, 1 << 14, 1)]


def test_p2_subtree_matches_plain(cuda):
    rng = np.random.default_rng(46)
    for w, stop, launches in P2_TREE_CASES:
        layer = _canonical(rng, (16, w)).to(cuda)
        levels = (w // stop).bit_length() - 1
        key_bits = 0b100001 if w == 1 << 18 else int(rng.integers(0, 1 << 20))
        for mont in (True, False):
            want = TP.tree_layers(layer, levels, key_bits, mont)
            before = build.LAUNCHES["p2_tree"]
            got = TC.tree_layers(layer, levels, key_bits, stop, mont)
            assert build.LAUNCHES["p2_tree"] == before + launches, (w, stop)
            assert len(got) == levels + 1 and got[-1].shape == (16, stop)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (w, stop, mont)
    view = _canonical(rng, (16, 2 * 4096)).to(cuda)[:, 1::2]  # a strided layer
    for mont in (True, False):
        assert all(torch.equal(a, b) for a, b in zip(TC.tree_layers(view, 12, 5, mont=mont),
                                                     TP.tree_layers(view, 12, 5, mont)))


def test_device_verifier_on_cuda(cuda):
    import dataclasses

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=4, data_src=DataSource("fake", seed=5))
    pi = oracle_pi(glob, dset, 1, 7)
    before = dict(build.LAUNCHES)
    assert TCIRC.verify_proof_input_device(glob, pi, device=cuda)
    bad = dataclasses.replace(pi, merkle_paths=[list(p) for p in pi.merkle_paths])
    bad.merkle_paths[0][3] ^= 1
    assert not TCIRC.verify_proof_input_device(glob, bad, device=cuda)
    grew = {k for k, n in build.LAUNCHES.items() if n != before[k]}
    assert grew == {"perm", "sponge2_planes"}


def test_sharded_2x2_mesh_on_one_card_matches_oracle(cuda):
    mesh = TPAR.make_mesh(n_cells_shards=2, n_slot_shards=2, devices=[cuda] * 4)
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=4, data_src=DataSource("fake", seed=5))
    assert TPAR.sharded_proof_input(glob, dset, 2, 7, mesh) == oracle_pi(glob, dset, 2, 7)
    entropy = GO.int_to_digest(7)
    for hash_fun in ("poseidon2", "monolith"):
        got = TPAR.sharded_gl_proof_input(hash_fun, glob, dset, 2, entropy, mesh)
        assert got == oracle_pi_gl(hash_fun, glob, dset, 2, entropy)


def test_checkpoint_resume_on_cuda(cuda, tmp_path):
    from codex_storage_proofs_circuits_tpu_torch.oracle.slot import SlotConfig, calc_slot_tree

    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=64, n_samples=1,
                     data_src=DataSource("fake", seed=77))
    ck = str(tmp_path / "ck")
    assert TS.streaming_slot_root(cfg, 16, device=cuda, checkpoint_dir=ck,
                                  stop_after_chunks=2) is None
    stats = TS.StreamingStats()
    assert TS.streaming_slot_root(cfg, 16, stats, device=cuda, checkpoint_dir=ck) == \
        calc_slot_tree(cfg).root
    assert (stats.chunks, stats.loaded) == (4, 2)


def test_nccl_all_gather_with_one_process(cuda):
    # the nccl route of parallel/distributed.py on one card (one process:
    # several cards are not available to this test): the host-name seating
    # of initialize() and the all_reduce of sum_over_processes
    import socket

    import torch.distributed as dist

    from codex_storage_proofs_circuits_tpu_torch.parallel import distributed as DD

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    DD.initialize("nccl", f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
        assert torch.equal(DD.sum_over_processes(t), t)
        assert torch.equal(DD.sum_over_processes(t.to(cuda)).cpu(), t)
        assert DD.make_global_mesh().shape == {"slots": 1, "cells": 1}
    finally:
        dist.destroy_process_group()


NCCL_RANK = """
import sys
from codex_storage_proofs_circuits_tpu_torch.parallel import distributed as DD
try:
    DD.initialize("nccl", sys.argv[1], world_size=2, rank=int(sys.argv[2]))
except ValueError as e:
    print("REFUSED", e, flush=True)
"""


def test_nccl_refuses_two_processes_on_one_card(cuda):
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_RANK, init, str(r)], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "REFUSED nccl needs one card a process: 2 processes on this host, 1 cards" in out


def test_tree_reduce_general_many_matches_plain(cuda):
    from codex_storage_proofs_circuits_tpu_torch.models import hashing as TH

    rng = np.random.default_rng(7)
    leaves = [TL.to_mont(TL.pack([int(v) for v in rng.integers(0, 2**62, w)]))
              for w in (1, 2, 3, 5, 8, 9, 40)]
    want = TH.tree_reduce_general_many(leaves)
    got = TH.tree_reduce_general_many([x.to(cuda) for x in leaves])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(torch.equal(a.cpu(), b) for a, b in zip(g, w))


def test_bench_torch_small_on_cuda(cuda, tmp_path, capsys):
    # bench_torch.py --small on the card: one JSON line, the small slot roots
    # equal the oracle's, and every rate and root ran on the kernels
    import json

    import bench_torch
    from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import (
        calc_slot_tree_gl,
    )
    from codex_storage_proofs_circuits_tpu_torch.oracle.slot import calc_slot_tree

    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    out = tmp_path / "metrics.json"
    assert bench_torch.main(["--small", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and "[cuda]" in json.loads(lines[0])["metric"]
    m = json.loads(out.read_text())
    assert m["compress"]["batch"] == 1 << 17 and m["gl_compress"]["batch"] == 1 << 16
    cfg, _ = bench_torch.slot_config(True, True)
    assert m["slot_root"]["slot_root"] == str(calc_slot_tree(cfg).root)
    for key, hash_fun in (("gl_slot_root", "poseidon2"), ("monolith_slot_root", "monolith")):
        assert m[key][key] == [str(v) for v in calc_slot_tree_gl(hash_fun, cfg).root]
    for k in ("perm", "p2_tree", "sponge2", "prng", "gl_perm", "mono_perm", "gl_sponge8",
              "mono_sponge8"):
        assert build.LAUNCHES[k] > 0, k


def test_microbench_kernels_match_plain(cuda):
    # M1-M6 of csrc/microbench.cu against their plain versions at one tile
    # of the tools' shapes (M1-M5 bitwise, M6 within 2.5e-4 relative), each
    # launch counted; the shapes the kernels are not built for are refused
    from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
    from codex_storage_proofs_circuits_tpu_torch.ops import microbench_plain as MP

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 1 << 16, (MP.ROWS, MP.COLS), dtype=np.uint32))
    b = torch.from_numpy(rng.integers(1, 1 << 16, (MP.ROWS, MP.COLS), dtype=np.uint32))
    ac, bc = a.to(cuda), b.to(cuda)
    cases = [("mb_mul", MC.mul, MP.mul), ("mb_add", MC.add, MP.add), ("mb_mix", MC.mix, MP.mix),
             ("mb_conv", MC.conv, MP.conv)]
    cases += [("mb_ilp", lambda x, y, n=n: MC.ilp(x, y, n), lambda x, y, n=n: MP.ilp(x, y, n))
              for n in MC.ILP_STREAMS]
    for counter, kernel, plain in cases:
        before = build.LAUNCHES[counter]
        assert torch.equal(kernel(ac, bc).cpu(), plain(a, b)), counter
        assert build.LAUNCHES[counter] == before + 1
    # M6 on one strip of the kernel (DOT_COLS) and one tile of the tools,
    # with 0 to 3 products (the edges of its two fragment buffers) and the
    # tool's count; columns 0-5 start at 250-255, so they reach 256 and stay
    for m, k in MC.DOT_SHAPES:
        wv = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.float32)).to(torch.bfloat16)
        for cols in (MC.DOT_COLS, MP.COLS):
            arr = rng.integers(0, 256, (k, cols)).astype(np.float32)
            arr[:, :6] = np.arange(250, 256)
            av = torch.from_numpy(arr).to(torch.bfloat16)
            for n_dots in (0, 1, 2, 3, 64 * 32 // k):
                before = build.LAUNCHES["mb_dot"]
                got = MC.dot(av.to(cuda), wv.to(cuda), n_dots).cpu()
                want = MP.dot(av, wv, n_dots)
                assert build.LAUNCHES["mb_dot"] == before + 1
                assert got.shape == want.shape, (m, k, cols, n_dots)
                assert bool(((got - want).abs() <= 2.5e-4 * want.abs()).all()), (m, k, cols, n_dots)
    with pytest.raises(ValueError):
        MC.ilp(ac, bc, 2)
    with pytest.raises(ValueError):  # a (16, 32) W is not one of the kernel's shapes
        MC.dot(av.to(cuda)[:32], wv.to(cuda)[:16, :32], 1)
    with pytest.raises(ValueError):  # A not at a 16-byte aligned address
        MC.dot(torch.zeros(32 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(32, 64),
               wv.to(cuda)[:64, :32].contiguous(), 1)
    with pytest.raises(ValueError):
        MC.mul(ac.to(torch.int32), bc.to(torch.int32))
