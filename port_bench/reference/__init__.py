"""The benchmark's plain reference: Poseidon2 over BN254 and Goldilocks,
the keyed Merkle trees, the reference's fake-data generator, the sampling
of cells and the dataset tree.

These modules are frozen copies of the port's pure-Python oracle
(`oracle/`, `fields/`) and of its plain-torch versions of the kernels
(`ops/limbs.py`, `ops/encode.py`, `ops/poseidon2_plain.py`,
`ops/gl_encode.py`, `ops/goldilocks_plain.py`, `convert.py`), as they
stood when the benchmark was written, with their imports pointed into this
folder and the Goldilocks constants' override hook left out.  They import
nothing of the program, so a later change to the program cannot move the
yardstick.  `fake_data.py` is the numpy generator of `models/data.py`
without the host C library.
"""
