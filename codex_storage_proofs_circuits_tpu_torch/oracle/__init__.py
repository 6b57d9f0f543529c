"""The bit-exact pure-Python oracle: Poseidon2 (BN254) and Goldilocks
hashes, Merkle trees, slots, datasets, sampling and the Goldilocks proof-input
pipeline.  The port's own copies of the JAX package's oracle modules of the
same names; the port's kernels and tests are judged against them."""
