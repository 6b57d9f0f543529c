"""The Goldilocks proof input's tail on the device (models/gl_proof_input.py):
the batched and the streaming paths, both hashes, fake and file-backed
slots, against the JAX package's oracle; the shared device sampler
(models/gl_hashing.sample_indices_gl) against the oracle's scalar sampler;
the stage spans and ProofStatsGL; the export's bytes, and the collector's
view of a proof's digests.

All comparisons are bit-exact.  The port runs its plain torch versions
here (device="cpu"); the plain sampler costs milliseconds a sample, so
nSamples stays at 10 or below.
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import dataclasses
import gc
import io

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    export_proof_input_gl as export_oracle,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import generate_proof_input_gl
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.models import gl_proof_input as TGPI
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks_pipeline as TGP

HASHES = ("poseidon2", "monolith")
GLOB = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
N_CELLS, N_SLOTS, N_SAMPLES = 32, 3, 10


def _dataset(source: str, tmp_path) -> DataSetConfig:
    if source == "fake":
        src = DataSource("fake", seed=4242)
    else:
        rng = np.random.default_rng(17)
        for k in range(N_SLOTS):
            (tmp_path / f"slot{k}.dat").write_bytes(
                rng.integers(0, 256, N_CELLS * GLOB.cell_size, np.uint8).tobytes())
        src = DataSource("file", filename=str(tmp_path / "slot.dat"))
    return DataSetConfig(n_slots=N_SLOTS, n_cells=N_CELLS, n_samples=N_SAMPLES, data_src=src)


def _generate(path: str, hash_fun, dset, slot, entropy, stats=None):
    if path == "streaming":
        return TGPI.generate_proof_input_gl_streaming(hash_fun, GLOB, dset, slot, entropy,
                                                      chunk_cells=16, device="cpu", stats=stats)
    return TGPI.generate_proof_input_gl(hash_fun, GLOB, dset, slot, entropy, device="cpu",
                                        stats=stats)


@pytest.mark.parametrize("source", ["fake", "file"])
@pytest.mark.parametrize("path", ["batched", "streaming"])
@pytest.mark.parametrize("hash_fun", HASHES)
def test_proof_input_matches_oracle(hash_fun, path, source, tmp_path):
    dset = _dataset(source, tmp_path)
    entropy = OG.int_to_digest(2**63 + 12345)
    want = generate_proof_input_gl(hash_fun, GLOB, dset, 1, entropy)
    got = _generate(path, hash_fun, dset, 1, entropy)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("log2n", [1, 5, 19, 32])
@pytest.mark.parametrize("hash_fun", HASHES)
def test_device_sampler_matches_the_oracle(hash_fun, log2n):
    rng = np.random.default_rng(log2n)
    entropy, root = (tuple(int(v) for v in rng.integers(0, OG.P_GL, 4, dtype=np.uint64))
                     for _ in range(2))
    n_samples = 6
    got = TGH.sample_indices_gl(hash_fun, entropy, TGH.digest_planes(root, "cpu"), n_samples,
                                log2n).tolist()
    assert got == [OG.sample_cell_index_gl(hash_fun, entropy, root, 1 << log2n, c)
                   for c in range(1, n_samples + 1)]


def test_device_sampler_refuses_more_than_32_bits():
    with pytest.raises(ValueError):
        TGH.sample_indices_gl("poseidon2", (1, 2, 3, 4), TGH.digest_planes((5, 6, 7, 8), "cpu"),
                              2, 33)


@pytest.mark.parametrize("path", ["batched", "streaming"])
def test_stats_and_spans(path, tmp_path, monkeypatch):
    # the spans' names as torch.profiler.record_function is given them (a
    # profiled run of the plain path takes minutes here)
    spans = []
    real = torch.profiler.record_function

    def spy(name):
        spans.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    dset = _dataset("fake", tmp_path)
    stats = TGPI.ProofStatsGL()
    _generate(path, "poseidon2", dset, 2, OG.int_to_digest(7), stats)
    stages = ["slots", "sample", "cells", "paths"]
    assert [n for n in spans if n.startswith("cspc.")] == [f"cspc.proof_gl.{s}" for s in stages]
    assert all(getattr(stats, f"{s}_s") > 0 for s in stages)
    assert (stats.samples, stats.cell_loads, stats.cell_bytes) == (
        N_SAMPLES, 1, N_SAMPLES * GLOB.cell_size)
    if path == "batched":  # the stats add up over calls
        _generate(path, "poseidon2", dset, 0, OG.int_to_digest(8), stats)
        assert (stats.samples, stats.cell_loads) == (2 * N_SAMPLES, 2)


def test_digests_and_export_leave_the_collector_no_quads(tmp_path):
    # digests and exported quads are tuples, which the collector stops
    # tracking, so a proof adds nothing towards a full collection; the
    # bytes are the oracle's
    dset = _dataset("fake", tmp_path)
    entropy = OG.int_to_digest(99)
    pi = _generate("streaming", "poseidon2", dset, 0, entropy)
    d = TGP.proof_input_gl_to_dict(pi)
    gc.collect()
    quads = ([q for c in pi.cell_data for q in c] + [q for p in pi.merkle_paths for q in p]
             + [q for c in d["cellData"] for q in c] + [q for p in d["merklePaths"] for q in p])
    assert quads and not any(gc.is_tracked(q) for q in quads)
    got, want = io.StringIO(), io.StringIO()
    TGP.export_proof_input_gl(got, pi)
    export_oracle(want, generate_proof_input_gl("poseidon2", GLOB, dset, 0, entropy))
    assert got.getvalue() == want.getvalue()
