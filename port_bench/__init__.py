"""The benchmark of the PyTorch/CUDA port (codex_storage_proofs_circuits_tpu_torch).

`python3 -m port_bench.run` runs one cell; BENCHMARK.json at the root of
the repository names the cells, and spec.py says which file holds what.
"""
